#!/usr/bin/env python3
"""K4/K5 phase of `chip_smoke.py` from one checkout of the repository.

    python3 tools/k45_compare.py <checkout root> [<checkout root> ...]

For each root in turn (one process each, so two checkouts of the port
never share a process): builds that checkout's `csrc/nerf_mlp.cu`, prints
nvcc's register and spill counts, then runs its `chip_smoke.k45_phase`
(K4 and K5 against their plain versions at a full-width train step's
262 144 points, times, bounds) and prints one `RESULT <root> {json}` line.
To compare two commits on one card, unpack the other into a directory
that .gitignore lists (`git archive <commit> | tar -x -C _proof/parent`)
and pass the roots in turns: parent, change, change, parent.
"""

import json
import os
import subprocess
import sys
import time


def run_one(root: str) -> None:
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    import chip_smoke as cs
    from nerfail_tpu_torch.ops.cuda import build

    t0 = time.time()
    logs = build.build_all(("nerf_mlp",))
    print(f"[{root}] build {time.time() - t0:.1f} s", flush=True)
    for text in logs.values():
        for line in text.splitlines():
            if ("registers" in line or "spill" in line or "error" in line
                    or "warning" in line):
                print(f"[ptxas] {line.strip()}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.card_line(), flush=True)
    rows = cs.k45_phase(torch.device("cuda", 0))
    print("RESULT", root, json.dumps(rows), flush=True)


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        run_one(os.path.abspath(sys.argv[2]))
        return 0
    rc = 0
    for root in sys.argv[1:]:
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one", root]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
