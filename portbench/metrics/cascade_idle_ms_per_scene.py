"""Device idle milliseconds per served scene while the host was inside a
``cascade`` span: the part of ``device_idle_pct.serve`` the cascade leaves;
the rest belongs to the caller (copies in and out, Python between requests)."""

from portbench.metrics._spans import idle_ms_per_unit

LAYER = "device"


def read(r):
    if r.unit != "scene":
        return None
    return idle_ms_per_unit(r, "cascade")
