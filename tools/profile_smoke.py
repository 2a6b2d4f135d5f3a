#!/usr/bin/env python3
"""Run ``chip_smoke.py`` under cProfile and write where its host time goes.

    python3 tools/profile_smoke.py [out_dir]   # default: chiprun_out

Run from the root of a checkout on a machine with the card. The smoke
run's own output goes to stdout as usual; the profile's 150 most
expensive functions by cumulative time and its 60 by own time go to
``<out_dir>/prof_cumulative.txt`` and ``<out_dir>/prof_tottime.txt``.
cProfile adds a few per cent to Python-heavy phases.
"""

import cProfile
import io
import os
import pstats
import runpy
import sys


def main() -> int:
    out_dir = sys.argv[1] if len(sys.argv) > 1 else "chiprun_out"
    smoke = os.path.abspath("chip_smoke.py")
    sys.argv = [smoke]
    prof = cProfile.Profile()
    code = 0
    try:
        prof.runcall(runpy.run_path, smoke, run_name="__main__")
    except SystemExit as e:
        code = e.code if isinstance(e.code, int) else 1
    os.makedirs(out_dir, exist_ok=True)
    for key, n in (("cumulative", 150), ("tottime", 60)):
        text = io.StringIO()
        pstats.Stats(prof, stream=text).sort_stats(key).print_stats(n)
        with open(os.path.join(out_dir, f"prof_{key}.txt"), "w") as f:
            f.write(text.getvalue())
    return code


if __name__ == "__main__":
    sys.exit(main())
