#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s Seamless-M4T phases alone on one card:
``decode_audio`` (a prefill that encodes 16 x 1,024 frames, then greedy
decode steps) and ``train_audio`` (``HostTrainer``, 2 rounds of 16 x 256
tokens), after its ``env`` and ``build`` phases.

    python3 tools/audio_phases.py [--root CHECKOUT]

``--root`` runs another checkout's ``chip_smoke.py`` and port (for
example the parent commit unpacked by ``git archive`` under ``build/``),
so that two commits can be compared in turns on the same card.  Prints
the phases' JSON lines (``prefill_s``, ``mean_step_ms``, each round's
``train_on_samples_s``) and the card's name and power limit.  Needs a
CUDA card; imports no JAX.
"""
import argparse
import os
import sys
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]),
                    help="the checkout whose chip_smoke.py and src/ to run")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path[:0] = [str(root / "src"), str(root)]
    os.chdir(root)
    import chip_smoke as cs

    gpu = cs.phase_env()
    cs.phase_build()
    rows = [{"name": f"row{i}"} for i in range(7)]
    cs.phase_decode_audio(rows, gpu)
    cs.phase_train_audio(rows, gpu)
    print(gpu, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
