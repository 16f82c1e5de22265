"""What the per-layer metric readers share: each reader in
`benchmark/metrics/` is a `read(ctx)` over the run's context, returning a
number or None when the run holds nothing for it to read. ctx: `config`
(the configuration file), `window` (the driver's window record), `host`
(the driver's host spans: seconds and frames of the program's calls, or
None), `slice` (the traced slice after the window that passed its check,
or None), `live` (live lanes at the window's close) and `notes` (a dict a
reader may fill; the result line carries it)."""

from __future__ import annotations

from . import counts


def host_us_per_frame(ctx):
    """The benchmark's spans around the program's calls: host seconds over
    their frames, in us."""
    h = ctx.get("host")
    if not h or not h.get("host_frames"):
        return None
    return h["host_s"] / h["host_frames"] * 1e6


def step_roofline_pct(ctx):
    """The step kernel's launches in the slice: their least time
    (`counts.step_bound_s`) over their traced device time, in %; the bound
    that applies goes to `notes["step_kernel"]`."""
    sl = ctx["slice"]
    if sl is None or not sl["summary"].get("step_s"):
        return None
    c = sl["counters"]
    launches = c.get("fused_step.launches", 0)
    packed = c.get("fused_step.render_launches", 0) + c.get("fused_step.render_f16_launches", 0)
    if launches <= 0:
        return None
    b = counts.step_bound_s(ctx["config"], launches, packed, sl["frames"], ctx["live"])
    ctx["notes"]["step_kernel"] = {"bound_by": b["bound_by"], "bound_s": b["bound_s"],
                                   "device_s": sl["summary"]["step_s"], "launches": launches}
    return 100.0 * b["bound_s"] / sl["summary"]["step_s"]


def nonstep_us_per_frame(ctx):
    """Device time of every kernel and copy in the slice but the step
    kernel's, per frame, in us."""
    sl = ctx["slice"]
    if sl is None or not sl["frames"]:
        return None
    s = sl["summary"]
    return (s["device_s"] - s["step_s"]) / sl["frames"] * 1e6


def idle_pct(ctx):
    """The share of the slice with nothing running on the device, in %."""
    sl = ctx["slice"]
    if sl is None or not sl["summary"].get("window_s"):
        return None
    s = sl["summary"]
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
