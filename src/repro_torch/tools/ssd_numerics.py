"""Why ``csrc/ssd.cu`` splits its fp32 operands (the gated scores G, the
state entering a chunk h, the state weights W) into bf16 hi + lo: on the
CPU, ``ref.ssd_chunked_tiles`` with the split and with one bf16 pass is
held against ``ref.ssd_chunked`` at mamba2-2.7b's SSD widths (80 heads of
64, one group of state 128, chunk 128; one row of one chunk and two rows of
four), on ``chip_smoke.py``'s kind of inputs. Prints one JSON line: the
largest |error| over chip_smoke.py's allowance (tol + tol |want|, tol 5e-2
for y, 1e-3 for the state) for each, so that 1.0 is the limit.

    PYTHONPATH=src python3 -m repro_torch.tools.ssd_numerics
"""
from __future__ import annotations

import json

import torch

from repro_torch.kernels import ref

Y_TOL, STATE_TOL = 5e-2, 1e-3  # chip_smoke.py's SSD_Y_TOL, SSD_STATE_TOL


def worst(got: torch.Tensor, want: torch.Tensor, tol: float) -> float:
    err = (got.float() - want.float()).abs()
    return float((err / (tol + tol * want.float().abs())).max())


def main() -> None:
    out = {}
    for rows, seq in ((1, 128), (2, 512)):
        g = torch.Generator().manual_seed(seq)

        def randn(*shape, dtype=torch.bfloat16):
            return torch.randn(shape, generator=g).to(dtype)

        x = randn(rows, seq, 80, 64)
        dt = torch.nn.functional.softplus(randn(rows, seq, 80, dtype=torch.float32))
        A, D = -torch.exp(randn(80, dtype=torch.float32)), randn(80, dtype=torch.float32)
        Bm, Cm = randn(rows, seq, 1, 128), randn(rows, seq, 1, 128)
        args = (x, dt, A, Bm, Cm, D)
        y_r, h_r = ref.ssd_chunked(*args, chunk=128, return_state=True)
        for name, hi_lo in (("hi_lo", True), ("one_bf16_pass", False)):
            y, h = ref.ssd_chunked_tiles(*args, chunk=128, return_state=True, hi_lo=hi_lo)
            out[f"{rows}x{seq}/{name}"] = {"y_over_tol": worst(y, y_r, Y_TOL),
                                           "state_over_tol": worst(h, h_r, STATE_TOL)}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
