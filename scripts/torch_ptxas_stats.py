"""Print ``nvcc -Xptxas -v``'s registers, shared memory and spills for every
CUDA source of the port (``color_modem_tpu_torch/csrc/*.cu``), compiled
with the flags of ``kernels/build.py`` into ``color_modem_tpu_torch/build/``.

    python3 scripts/torch_ptxas_stats.py
"""

from __future__ import annotations

import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from color_modem_tpu_torch.kernels.build import (  # noqa: E402
    BUILD_DIR,
    CSRC_DIR,
    NVCC_FLAGS,
    find_nvcc,
)


def main() -> None:
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(exist_ok=True)
    sources = sorted(CSRC_DIR.glob("*.cu"))
    cmds = [[nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
             str(BUILD_DIR / f"stats.{f.stem}.{os.getpid()}.o"), str(f)] for f in sources]
    with ThreadPoolExecutor(max_workers=len(cmds)) as pool:
        results = list(pool.map(lambda c: subprocess.run(c, capture_output=True, text=True),
                                cmds))
    failed = False
    for f, c, r in zip(sources, cmds, results):
        print(f"== {f.name} (rc {r.returncode})")
        for line in r.stderr.splitlines():
            if r.returncode or any(k in line for k in ("Compiling entry", "registers", "spill",
                                                        "bytes stack")):
                print("  " + line.strip())
        if os.path.exists(c[-2]):
            os.unlink(c[-2])
        failed |= r.returncode != 0
    if failed:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
