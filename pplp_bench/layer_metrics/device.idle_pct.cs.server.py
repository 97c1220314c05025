"""Share of the server process's traced stretch (its traced sessions back to
back, the harness's ``Stretch`` in that process) in which its device ran no
kernel and no copy (a client/server cell; sent back over the control pipe)."""


def read(view):
    trace = (view.work.get("server") or {}).get("trace")
    if not trace or not trace["device_ops"] or trace["window_s"] <= 0:
        return None
    return 100 * (1 - trace["busy_s"] / trace["window_s"])
