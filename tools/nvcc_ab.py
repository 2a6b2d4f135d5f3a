#!/usr/bin/env python3
"""Build every kernel source twice, with the port's nvcc flags and with them
less ``--split-compile``, and compare the two builds.

    python3 tools/nvcc_ab.py

Run from the root of a checkout on a machine with ``nvcc``. Each build
starts one ``nvcc`` a source, all together, as ``kernels/build.py`` does,
into a temporary directory. Prints, for each build, every source's own
seconds and the wall time, then whether the two builds hold the same
functions and which functions' SASS (``cuobjdump -sass``, addresses
stripped) differs.
"""

import hashlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.getcwd())
from fast_image_recognition_tpu_torch.kernels import build  # noqa: E402


def build_all(flags, out_dir):
    """Seconds each source took, and the wall time of the whole build."""
    t0, procs, ends = time.time(), {}, {}
    for n, src in build.SOURCES.items():
        cmd = [build._nvcc(), *flags, "-o", os.path.join(out_dir, f"{n}.so"), os.path.join(build.KERNEL_DIR, src)]
        procs[n] = subprocess.Popen(cmd, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    for n, p in procs.items():
        err = p.communicate()[1]
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {n}: {err[-2000:]}")
    # communicate() above may return late for a source that ended early:
    # take each source's end from the file's modification time instead
    for n in procs:
        ends[n] = round(os.path.getmtime(os.path.join(out_dir, f"{n}.so")) - t0, 1)
    return ends, round(time.time() - t0, 1)


def sass_by_function(out_dir):
    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    funcs = {}
    for n in build.SOURCES:
        text = subprocess.run([cuobjdump, "-sass", os.path.join(out_dir, f"{n}.so")],
                              capture_output=True, text=True, check=True).stdout
        fn, body = None, []
        for line in text.splitlines() + ["Function : <end>"]:
            if "Function : " in line:
                if fn:
                    funcs[fn] = hashlib.sha256("\n".join(body).encode()).hexdigest()
                fn, body = re.search(r"Function : (\S+)", line).group(1), []
            elif fn and re.match(r"\s+/\*[0-9a-f]{4}\*/", line):
                body.append(re.sub(r"/\*[0-9a-f]{4}\*/", "", line).strip())
    return funcs


def main() -> int:
    split = [f for f in build.NVCC_FLAGS if f.startswith("--split-compile")]
    plain_flags = [f for f in build.NVCC_FLAGS if f not in split]
    sass = {}
    for tag, flags in (("without " + " ".join(split), plain_flags), ("with the port's flags", build.NVCC_FLAGS)):
        with tempfile.TemporaryDirectory() as d:
            ends, wall = build_all(flags, d)
            sass[tag] = sass_by_function(d)
        print(json.dumps({"build": tag, "seconds": ends, "wall": wall, "functions": len(sass[tag])}), flush=True)
    a, b = sass.values()
    differ = sorted(f for f in a if a[f] != b.get(f))
    print(json.dumps({"same_functions": set(a) == set(b), "functions": len(a), "sass_differs": differ}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
