#!/usr/bin/env python3
"""How far the decode-attention kernels (rows 9 and 10,
``acestep_tpu_torch/ops/cuda/decode_attn.py``) part from their plain versions
on the card: the readings behind ``TIGHT_REL`` in
``tests/test_torch_cuda_decode.py``.

    python3 tools/decode_attn_errors.py

For every case of that file's ``ATTN_CASES`` and each layer it prints each
kernel's largest error relative to the output's peak, and whether row 10's
output equals, bit for bit, row 9's run on ``rms_norm_rope``'s post-rope q and
k (row 10 is row 9's attention behind its prologue, so equal bits mean the
kernel's prologue gives ``rms_norm_rope``'s values).  Then, on the rising
caches of ``test_global_anchor_misses_the_bound_on_the_card``, each kernel's
error beside the test-only mirror of its phases with the block anchor and with
the global anchor.  The card's name and power limit come first.  Needs one
NVIDIA GPU; imports no JAX.
"""

from __future__ import annotations

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("decode_attn_errors: no CUDA device", file=sys.stderr)
        return 2
    import test_torch_cuda_decode as cases
    from acestep_tpu_torch.ops.cuda import decode_attn as tattn

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"card: {smi.stdout.strip()}; torch {torch.__version__}", flush=True)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    rel = cases._rel
    worst = [0.0, 0.0]
    for case in cases.ATTN_CASES:
        (q, kq, ks, vq, vs, lens, k_self, v_self), (qn, kn, cos, sin) = \
            cases._attn_inputs(case, dev)
        for li in range(case[4]):
            args = (q, kq, ks, vq, vs, lens, li, k_self, v_self)
            e9 = rel(tattn.decode_attention_int8_stacked(*args),
                     tattn.decode_attention_plain(*args))
            fargs = (q, k_self, v_self, qn, kn, cos, sin, kq, ks, vq, vs, lens, li)
            got = tattn.decode_attention_fused_stacked(*fargs)[0]
            e10 = rel(got, tattn.decode_attention_fused_plain(*fargs)[0])
            qp = tattn.rms_norm_rope(q, qn, cos, sin, 1e-6)
            kp = tattn.rms_norm_rope(k_self, kn, cos, sin, 1e-6)
            same = torch.equal(got, tattn.decode_attention_int8_stacked(
                qp, kq, ks, vq, vs, lens, li, kp, v_self))
            worst = [max(worst[0], e9), max(worst[1], e10)]
            print(f"{case[:4]} lengths {case[5]} layer {li}: row 9 {e9:.3e}, row 10 {e10:.3e}, "
                  f"row 10 == row 9 on rms_norm_rope's q/k: {same}", flush=True)
    print(f"largest: row 9 {worst[0]:.3e}, row 10 {worst[1]:.3e}", flush=True)
    for fused in (False, True):
        fn, args, plain, att = cases.rising_case(dev, fused)
        got, ref = fn(*args), plain(*args)
        got, ref = (got[0], ref[0]) if fused else (got, ref)
        print(f"rising cache, row {10 if fused else 9}: kernel {rel(got, ref):.3e}, mirror with "
              f"the block anchor {rel(tattn.decode_attention_split_mirror(*att), ref):.3e}, "
              f"with the global anchor "
              f"{rel(tattn.decode_attention_split_mirror(*att, anchor='global'), ref):.3e}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
