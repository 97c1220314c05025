"""The server's filter insert's share of its roofline: the least time of
the insert (``yardstick.bloom_insert``: the table written once, every key
hashed once a salt) over the device time a session of the operations
launched in the server's ``setBF`` stage, over the server's traced sessions
(its process's own profiled stretch, sent back over the control pipe)."""

from pplp_bench import yardstick


def read(view):
    trace = (view.work.get("server") or {}).get("trace")
    if not trace or trace["setbf_device_s"] <= 0:
        return None
    w = view.work
    return 100 * yardstick.bloom_insert(w["keys"], w["salts"], w["table_bits"])["seconds"] \
        / trace["setbf_device_s"]
