"""Readings that several per-layer metrics share. A metric's file under
``layer_metrics/`` names one of these as its ``read``, or defines its own."""

from statistics import fmean

from pplp_bench import yardstick


def idle_pct(view):
    """Share of the traced stretch in which no kernel and no copy ran on the
    device."""
    st = view.stretch
    if st is None or not st.device_ops or st.window_s <= 0:
        return None
    return 100 * (1 - st.busy_s / st.window_s)


def unit_ms_p90(view):
    """90th percentile of a unit's host-clock milliseconds, over the units
    before the profiler started."""
    unit_s, _ = view.window.steady()
    return 1e3 * yardstick.quantile(unit_s, 0.9) if unit_s else None


def kernels_per_step(view):
    """Kernels the device ran a step, over the traced steps (copies left out)."""
    st = view.stretch
    if st is None or not st.kernels():
        return None
    return len(st.kernels()) / st.units


def step_roofline_pct(view):
    """The packed step's share of its roofline: the least time of a step
    (``yardstick.packed_step``, counted from the shapes and the reference's
    probe) over the device time of every kernel of the traced steps, a step.
    The traced steps cycle the batches evenly, so the bound is their mean."""
    st = view.stretch
    if st is None or not st.kernels():
        return None
    w = view.work
    least = fmean(yardstick.packed_step(w["rows"], w["limbs"], w["n"], w["table_bits"],
                                        w["salts"], tested)["seconds"]
                  for tested in w["salts_tested"])
    kernel_s = sum(e - s for _, s, e in st.kernels()) * 1e-6 / st.units
    return 100 * least / kernel_s


def stage_ms(*stages):
    """A reader of the mean host-clock milliseconds a unit spends in the
    spans ``stages`` together, over the units before the profiler started."""
    def read(view):
        _, spans = view.window.steady()
        per_unit = [sum(s[k] for k in stages) for s in spans if all(k in s for k in stages)]
        return 1e3 * fmean(per_unit) if per_unit else None

    return read
