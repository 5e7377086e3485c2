"""Run a checkout's ``chip_smoke.py`` with the wall time of each of its
phases, and of each recipe it trains, printed to standard error.

    cd <checkout> && python3 <any checkout>/scripts/smoke_phase_times.py [chip_smoke.py's flags]

It imports ``chip_smoke`` from the current directory and calls its
``main()`` unchanged, so two checkouts (a parent and a change) are timed
alike within one call on one card; standard output and the exit code are
``chip_smoke.py``'s own. Lines read ``[phase time] <function>[ <recipe>]:
<seconds> s``; a phase that calls another prints both.
"""

import functools
import os
import sys
import time

sys.path.insert(0, os.getcwd())
import chip_smoke  # noqa: E402


def _timed(name, fn):
    @functools.wraps(fn)
    def run(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            what = f"{name} {args[0]}" if name == "_train_recipe" else name
            print(f"[phase time] {what}: {time.perf_counter() - t0:.1f} s", file=sys.stderr,
                  flush=True)
    return run


for _name in dir(chip_smoke):
    if _name.startswith("phase_") or _name == "_train_recipe":
        setattr(chip_smoke, _name, _timed(_name, getattr(chip_smoke, _name)))

if __name__ == "__main__":
    chip_smoke.main()
