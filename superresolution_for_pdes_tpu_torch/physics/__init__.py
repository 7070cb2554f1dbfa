"""Physics-informed loss terms."""
