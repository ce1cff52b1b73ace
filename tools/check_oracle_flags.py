"""Bitwise-verify + time a candidate native-oracle flag set.

The native oracle (ops/oracle_native.cpp) exists to reproduce the scalar
reference estimator bit-exactly, so any compiler-flag change must be proven
value-identical before it is trusted. This renders the same N sweeps of the
64x64 cbox oracle twice — default flags vs HIJIKI_ORACLE_CFLAGS candidate —
in separate subprocesses (the flag set is part of the .so cache key,
utils/native.py shared_object) and compares the f64 accumulators bitwise.

Usage:
  python tools/check_oracle_flags.py "-O3 -march=native" [--spp 32]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def render(flags: str, out: str, spp: int) -> float:
    env = dict(os.environ, HIJIKI_ORACLE_CFLAGS=flags, JAX_PLATFORMS="cpu")
    if os.path.exists(out):
        os.unlink(out)
    # warm the .so cache outside the timed region (build is ~seconds)
    subprocess.run(
        [sys.executable, "-c",
         "from hijiki.ops.oracle_native import load_library; "
         "assert load_library() is not None"],
        env=env, cwd=REPO, check=True,
    )
    t0 = time.monotonic()
    subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "oracle_mse.py"),
         "oracle", "--native", "--spp", str(spp), "--out", out],
        env=env, cwd=REPO, check=True,
    )
    return time.monotonic() - t0


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("candidate", help="extra flags, e.g. '-O3 -march=native'")
    ap.add_argument("--spp", type=int, default=32)
    args = ap.parse_args()

    with tempfile.TemporaryDirectory() as tmp:
        fa, fb = os.path.join(tmp, "a.npz"), os.path.join(tmp, "b.npz")
        ta = render("", fa, args.spp)
        tb = render(args.candidate, fb, args.spp)
        a = np.load(fa)["acc"]
        b = np.load(fb)["acc"]
    # compare BIT patterns, not values: np.array_equal would pass a
    # +0.0 vs -0.0 divergence (a real sign of changed FP codegen)
    same = (a.dtype == b.dtype and a.shape == b.shape
            and bool(np.array_equal(a.view(np.uint8), b.view(np.uint8))))
    print(f"bitwise_equal={same}  default={ta:.1f}s  candidate={tb:.1f}s  "
          f"speedup={ta / tb:.3f}x")
    if not same:
        diff = np.abs(a - b)
        print(f"  max abs diff {diff.max():.3e} at "
              f"{np.unravel_index(diff.argmax(), diff.shape)}")
        sys.exit(1)


if __name__ == "__main__":
    main()
