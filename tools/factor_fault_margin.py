#!/usr/bin/env python3
"""How far the factor-sharded path's agreement gates sit from a planted fault.

    python3 tools/factor_fault_margin.py [FAULT ...]

Runs chip_smoke.py's factor-sharded arms (A and B on 2 ranks, C on 4; see
``factor_sharded_path``) once as the code stands ("none") and once per
planted fault, and prints for each arm the worst update agreement with the
1-rank reference, as the smoke's gates read it (1 - cosine and the relative
error |u_k - u_1| / |u_1|, over every routed leaf and step), and the largest
drift of the replicated state.  A fault replaces one collective of
``parallel.mesh.MeshAxes`` by the rank's own value, in every rank:

- ``max``: the pmax of a diagonal factor's ell and of the balance norms;
- ``sum``: the psum of term1 (and Newton's term2).

The default runs "none", "max" and "sum".  The gates are not applied here:
a faulty run reports its numbers instead of failing.  The last line is one
JSON object of every reading.  Imports nothing of JAX; needs the card.
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

FAULTS = ("none", "max", "sum")
# the rank processes re-import this file as their main module, so the fault
# chosen by the parent (through the environment) is planted in every rank
_FAULT = os.environ.get("FACTOR_FAULT", "none")
if _FAULT != "none":
    from psgd_torch_tpu_torch.parallel.mesh import MeshAxes

    def _own(self, x, axes):
        return x.clone()

    setattr(MeshAxes, _FAULT, _own)


def _readings(arms: list) -> list:
    """Per arm of one spawn (``arms[r][j]``: rank r, arm j) its label,
    worst (1 - cosine, relative error) and largest drift over the ranks."""
    out = []
    for j in range(len(arms[0])):
        head = arms[0][j]
        agree = [v for step in head["agree"] for v in step.values()]
        out.append(dict(label=head["label"], ranks=len(arms),
                        one_minus_cos=max(a[0] for a in agree),
                        rel_err=max(a[1] for a in agree),
                        drift=max(max(a[j]["drift"].values()) for a in arms),
                        losses=head.get("losses")))
    return out


def main(argv=None) -> int:
    faults = list(argv if argv is not None else sys.argv[1:]) or list(FAULTS)
    unknown = [f for f in faults if f not in FAULTS]
    if unknown:
        raise SystemExit(f"unknown faults {unknown}; choose from {FAULTS}")
    import torch
    import chip_smoke as cs
    _, card = cs.preflight()
    torch.cuda.set_device(0)
    cs.build()
    result = {}
    for fault in faults:
        os.environ["FACTOR_FAULT"] = fault
        rows = (_readings(cs._spawn("factor:ab", 2))
                + _readings(cs._spawn("factor:c", 4)))
        for row in rows:
            print(f"[{card}] fault {fault}: {row['label']} on {row['ranks']} ranks: "
                  f"worst 1 - cosine {row['one_minus_cos']!r}, relative error "
                  f"{row['rel_err']!r}, drift {row['drift']!r}, losses {row['losses']}",
                  flush=True)
        result[fault] = rows
    os.environ.pop("FACTOR_FAULT")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
