#!/usr/bin/env python3
"""Some of chip_smoke.py's paths alone, for one checkout or several in turns.

    python3 tools/smoke_paths.py PATH [PATH ...] [--root DIR ...]

Each PATH is a function of chip_smoke.py that takes (device, card) and
drives one path: for example ``stack_sharded_path pair_paths
factor_sharded_path vector_sharded_path sharded_trainer_path
tp_trainer_path llama_tp_path`` (the distributed paths; ``tp_trainer_path``
is GPT-2 124M's widths and ``llama_tp_path`` LLaMA-1.1B's in JAX's (dp 1,
fsdp 2, tp 2) layout on 4 rank processes of one card over gloo), ``vector_fault_margin`` and ``tp_fault_margin`` (the
vector-sharded and tensor-parallel paths' runs with a planted fault
each), ``legacy_path`` (the legacy families), ``examples_path
ns_widths_path`` (the five examples ported from examples/ and the
NS-width sweep of tools/bench_ns_widths_torch.py) or ``newton_path:gpt2
gpt2_path`` (a ``name:arg`` passes ``arg`` first).  For each ``--root`` in the order given (default:
the checkout this file is in; give a parent checkout and this one as
``--root P --root C --root C --root P`` to compare two trees on one card in
turns) a fresh process imports that checkout's chip_smoke.py, runs its
preflight (the card's name and power limit) and build, then the paths, and
prints their log.  Exits non-zero if a process failed.  Imports nothing of
JAX; needs the card.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

_RUN = """
import sys, torch
sys.path.insert(0, '.')
import chip_smoke as cs
name, smi = cs.preflight()
dev = torch.device('cuda', 0)
torch.cuda.set_device(dev)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
cs.build()
try:
    for spec in sys.argv[1:]:
        fn, _, arg = spec.partition(':')
        args = (arg, dev, smi) if arg else (dev, smi)
        cs.phase(spec)
        getattr(cs, fn)(*args)
finally:
    cs.close_ranks()
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("paths", nargs="+")
    ap.add_argument("--root", action="append")
    opts = ap.parse_args(argv)
    roots = opts.root or [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
    rc = 0
    for root in roots:
        print(f"== {root}", flush=True)
        # a run's own stdout and stderr go straight through
        out = subprocess.run([sys.executable, "-c", _RUN, *opts.paths], cwd=root)
        print(f"== {root}: exit {out.returncode}", flush=True)
        rc = rc or out.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
