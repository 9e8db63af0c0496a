"""Readings of the port's own spans (``cammiq_tpu_torch/utils/timing.py``),
the arithmetic that a per-layer metric reader applies to the tracer's
totals.

``readings(totals)`` turns the totals of one sample (``Recorded.totals()``:
``{name: [count, total_ns, max_ns]}``) into milliseconds a sample by
``READINGS``, the passes the sample ran (one more ``query.pass`` for each
pass re-run on overflow), and the shares of ``query.pass`` and
``quant.build_problem`` that their parts cover (``cover``).
``session_start_s(totals)`` reads the totals recorded before a window.

No cell's result line reads them yet: the harness runs with the tracer
off.  Once ``harness.run_cell`` switches the tracer on under ``--trace 1``
and hands its readers the totals, the metric readers under ``metrics/``
import this module.
"""

from __future__ import annotations

# reading: the spans it sums, milliseconds a sample
READINGS = {
    "stage_ms": ("pass.stage",),
    "upload_wait_ms": ("pass.upload_wait",),
    "issue_ms": ("pass.classify",),
    "pair_lookup_ms": ("pass.pair_lookup",),
    "drain_ms": ("pass.drain",),
    "problem_scan_ms": ("problem.entry_sizes", "problem.entry_weights"),
    "query_run_ms": ("query.run",),
    "build_problem_ms": ("quant.build_problem",),
    "solve_ms": ("quant.solve",),
}
PASS_PARTS = ("pass.stage", "pass.upload_wait", "pass.classify",
              "pass.pair_lookup", "pass.drain")
PROBLEM_PARTS = ("problem.prefilter", "problem.entry_sizes",
                 "problem.entry_weights", "problem.terms", "problem.bounds")
SESSION_START = ("session.open", "session.index_to_device",
                 "session.pair_keys", "kernels.load")


def ms(totals: dict, names) -> float:
    return sum(totals.get(n, (0, 0, 0))[1] for n in names) / 1e6


def readings(totals: dict) -> dict:
    """One sample's readings from the tracer's totals; a reading whose
    spans are all absent is left out."""
    out = {k: ms(totals, names) for k, names in READINGS.items()
           if any(n in totals for n in names)}
    if "query.pass" in totals:
        out["passes"] = totals["query.pass"][0]
    out.update(cover(lambda names: ms(totals, names)))
    return out


def cover(sum_ms) -> dict:
    """The shares of ``query.pass`` and ``quant.build_problem`` that their
    parts cover, from ``sum_ms(names)``, where the whole was recorded."""
    out = {}
    for key, parts, whole in (("cover_pass", PASS_PARTS, "query.pass"),
                              ("cover_build_problem", PROBLEM_PARTS,
                               "quant.build_problem")):
        w = sum_ms((whole,))
        if w:
            out[key] = sum_ms(parts) / w
    return out


def session_start_s(totals: dict) -> float | None:
    """Seconds of the session's start in the totals recorded before a
    window; None where none of its spans were recorded (a port without
    the tracer)."""
    if not any(n in totals for n in SESSION_START):
        return None
    return ms(totals, SESSION_START) / 1e3
