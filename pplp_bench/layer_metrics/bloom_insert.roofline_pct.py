"""The filter insert's share of its roofline: the least time of the insert
(``yardstick.bloom_insert``: the table written once, every key hashed once
a salt) over the device time of every operation inside the ``setBF`` span,
the mean over the traced tests."""

from statistics import fmean

from pplp_bench import yardstick


def read(view):
    st = view.stretch
    per_test = [s for s in st.device_s_in("setBF") if s > 0] if st else []
    if not per_test:
        return None
    w = view.work
    return 100 * yardstick.bloom_insert(w["keys"], w["salts"], w["table_bits"])["seconds"] \
        / fmean(per_test)
