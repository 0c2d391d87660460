"""Share of the tracking thread's map-lock wait in which the holder had a
loop-closing span open (``mapping.loop_closing`` and its stages, or
``mapping.gba``), in percent of the whole wait."""
from benchmark import program_records as pr


def read(run):
    recs = pr.tracked(run)
    if recs is None:
        return None
    waits = pr.spans(recs, "slice.map_lock_wait")
    all_ms = pr.wall_ms(waits)
    if all_ms <= 0:
        return None
    return 100.0 * pr.wall_ms([r for r in waits if pr.held_by_loop(r)]) / all_ms
