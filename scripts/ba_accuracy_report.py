"""Windowed-BA accuracy delta in the integrated pipeline.

Runs the SAME scenario frames through lvt_tpu with local_ba_window=0 and =4
and prints ATE/RPE/rot for both, plus the oracle golden for reference.
Feeds the BASELINE.md windowed-BA row.

Usage: JAX_PLATFORMS=cpu python scripts/ba_accuracy_report.py [scenario ...]
"""

from __future__ import annotations

import dataclasses
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np

from tools.oracle.scenarios import GOLDEN_DIR, by_name, parity_rows, run_lvt


def run(sc, ba_window: int):
    """(ATE, RPE(1), rot) of lvt_tpu on the scenario's frames."""
    sc = dataclasses.replace(
        sc, vo_overrides=(("local_ba_window", ba_window),))
    return tuple(row[1] for row in parity_rows(sc, *run_lvt(sc)))


def main():
    names = sys.argv[1:] or ["noisy", "textured", "tex_lowtex"]
    for name in names:
        sc = by_name(name)
        g = np.load(GOLDEN_DIR / f"{name}.npz")
        off = run(sc, 0)
        on = run(sc, 4)
        print(f"{name:12s} oracle ATE {float(g['ate']):7.4f}  "
              f"BA-off ATE {off[0]:7.4f} RPE {off[1]:6.4f} rot {off[2]:6.3f}  "
              f"BA-4 ATE {on[0]:7.4f} RPE {on[1]:6.4f} rot {on[2]:6.3f}  "
              f"(ATE delta {100 * (on[0] - off[0]) / max(off[0], 1e-9):+.1f}%)",
              flush=True)


if __name__ == "__main__":
    main()
