#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (acestep_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each announced by a timestamped line:
  1. gpu      the card's name and power limit (nvidia-smi)
  2. build    compile csrc/*.cu with one nvcc call into build/kernels/ (ctypes)
  3. check    each kernel against its plain PyTorch version at the main path's
              shapes plus ragged edges (q8_0 matmul atol 1e-2 + rtol 1e-2 in
              bf16; VAE res unit / trio 1e-4 in f32)
  4. engine   the full-width random q8_0 engine, built on the card
  5. serve    the bench request (10 s text2music, 64 style + 256 lyric tokens,
              one seed) three times through AceStepEngine.generate: one warm-up,
              two timed; every kernel's launch count per request must be > 0
  6. output   audio_lengths == [480000], int16 [1, >=480000, 2], non-constant,
              finite positive scale; a small engine on the card (kernels)
              against the same engine on the CPU (plain versions): the Q8_0
              gate, cosine >= 0.999 and SNR >= 26 dB
  7. recheck  every (kernel, shape) the served requests launched that phase 3
              did not cover, against the plain version
  8. timing   kernel, plain-version and library-call times at the served
              shapes, beside the bound (bytes over 3.35 TB/s or operations over
              989 TFLOP/s bf16 / 67 TFLOP/s f32)
Then one {"kernels": [...]} line, the nvidia-smi line, and last the result line.
A watchdog ends the run with a non-zero code, naming the phase that overran.
Without a card, or outside the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import threading
import time

WATCHDOG_S = 1100          # whole run, the kernels' build included (limit 1200 s)
QMM_ATOL, QMM_RTOL = 1e-2, 1e-2
RES_TOL = 1e-4
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12

T0 = time.perf_counter()
_state = {"phase": "start"}


def log(msg: str) -> None:
    print(f"[chip_smoke {time.strftime('%H:%M:%S')} +{time.perf_counter() - T0:7.1f}s] {msg}",
          flush=True)


def phase(name: str) -> None:
    _state["phase"] = name
    log(f"== phase {name}")


def _watchdog() -> None:
    deadline = T0 + WATCHDOG_S
    while time.perf_counter() < deadline:
        time.sleep(1.0)
    print(f"[chip_smoke] watchdog: phase '{_state['phase']}' overran {WATCHDOG_S} s",
          flush=True)
    os._exit(3)


class Failure(Exception):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise Failure(msg)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def cuda_ms(fn, iters: int = 10) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float, peak_flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def max_err(got, ref) -> float:
    return float((got.float() - ref.float()).abs().max())


def check_close(name, got, ref, atol, rtol) -> float:
    import torch

    err = max_err(got, ref)
    ok = bool(torch.all((got.float() - ref.float()).abs()
                        <= atol + rtol * ref.float().abs()))
    require(bool(torch.isfinite(got.float()).all()), f"{name}: non-finite kernel output")
    log(f"  {name}: max_abs_err {err:.3e} (atol {atol:g}, rtol {rtol:g}) "
        f"{'ok' if ok else 'FAIL'}")
    require(ok, f"{name}: kernel disagrees with its plain version")
    return err


class QmmCase:
    """A random q8_0 weight [K, N] and activations [M, K] on the card."""

    def __init__(self, m, k, n, seed):
        import torch
        from acestep_tpu_torch.quant import QuantTensor, dequantize, quantize_q8_0

        g = torch.Generator(device="cuda").manual_seed(seed)
        q = quantize_q8_0(torch.randn((k, n), generator=g, device="cuda") * 0.02)
        self.qt = QuantTensor("q8_0", (k, n), q.data, q.scales.float())
        self.x = torch.randn((m, k), generator=g, device="cuda").bfloat16()
        self.wd = dequantize(self.qt, torch.bfloat16)
        self.m, self.k, self.n = m, k, n

    def bound(self):
        m, k, n = self.m, self.k, self.n
        nbytes = m * k * 2 + k * n + (k // 32) * n * 4 + m * n * 2
        return bound_ms(nbytes, 2.0 * m * k * n, BF16_FLOPS)


def _unit_params(c, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)

    def r(*shape, s=0.3):
        return torch.randn(shape, generator=g, device="cuda") * s

    return {"snake1": {"alpha": r(c), "beta": r(c)},
            "conv1": {"w": r(7, c, c, s=1.0 / math.sqrt(7 * c)), "b": r(c, s=0.05)},
            "snake2": {"alpha": r(c), "beta": r(c)},
            "conv2": {"w": r(1, c, c, s=1.0 / math.sqrt(c)), "b": r(c, s=0.05)}}


def _res_x(n, length, c, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn((n, length, c), generator=g, device="cuda") * 0.5


def res_bound(n, length, c, units):
    nbytes = 2 * n * length * c * 4 + units * (8 * c * c + 6 * c) * 4
    return bound_ms(nbytes, units * 2.0 * n * length * c * c * 8, F32_FLOPS)


def check_qmm(shape, seed) -> float:
    from acestep_tpu_torch.ops.cuda import qmm

    case = QmmCase(*shape, seed)
    got = qmm._launch(case.x, case.qt, None, case.x.dtype)
    return check_close(f"q8_0_qmm M={shape[0]} K={shape[1]} N={shape[2]}", got,
                       qmm.qmm_plain(case.x, case.qt), QMM_ATOL, QMM_RTOL)


def check_unit(shape, seed) -> float:
    from acestep_tpu_torch.ops.cuda import vae_resunit as vru

    n, length, c, d = shape
    x = _res_x(n, length, c, seed)
    tens = vru.unit_tensors(_unit_params(c, seed), x.device)
    return check_close(f"vae_res_unit N={n} L={length} C={c} d={d}",
                       vru.launch_unit(x, tens, d), vru.res_unit_plain(x, *tens, d),
                       RES_TOL, RES_TOL)


def check_trio(shape, seed) -> float:
    from acestep_tpu_torch.ops.cuda import vae_resunit as vru

    n, length, c = shape
    x = _res_x(n, length, c, seed)
    st = vru.trio_tensors(tuple(_unit_params(c, seed + i) for i in range(3)), x.device)
    return check_close(f"vae_res_trio N={n} L={length} C={c}", vru.launch_trio(x, st),
                       vru.res_trio_plain(x, *st), RES_TOL, RES_TOL)


def main_path_shapes(dit_cfg, text_cfg, n_style=64, n_lyric=256, frames=256):
    """The q8_0 matmul shapes (M, K, N) a 10 s batch-1 request launches (from the
    configs)."""
    h, hd = dit_cfg.hidden_size, dit_cfg.head_dim
    nh, nkv, inter = dit_cfg.num_attention_heads, dit_cfg.num_key_value_heads, \
        dit_cfg.intermediate_size
    th = text_cfg.hidden_size
    tp = frames // dit_cfg.patch_size
    lc = n_style + n_lyric
    qmm = {
        # text encoder (M = style tokens)
        (n_style, th, text_cfg.num_attention_heads * text_cfg.head_dim),
        (n_style, th, text_cfg.num_key_value_heads * text_cfg.head_dim),
        (n_style, text_cfg.num_attention_heads * text_cfg.head_dim, th),
        (n_style, th, text_cfg.intermediate_size),
        (n_style, text_cfg.intermediate_size, th),
        (n_style, dit_cfg.text_hidden_dim, h),                  # text_projector
        # lyric encoder (M = lyric tokens)
        (n_lyric, dit_cfg.text_hidden_dim, h), (n_lyric, h, nh * hd), (n_lyric, h, nkv * hd),
        (n_lyric, nh * hd, h), (n_lyric, h, inter), (n_lyric, inter, h),
        # condition projection and cross K/V (M = packed condition)
        (lc, h, h), (lc, h, nkv * hd),
        # timestep embeddings (M = batch)
        (1, 256, h), (1, h, h), (1, h, 6 * h),
        # decoder (M = patches): proj_in, fused qkv, o, cross q/o, fused gate-up, down, proj_out
        (tp, dit_cfg.in_channels * dit_cfg.patch_size, h), (tp, h, (nh + 2 * nkv) * hd),
        (tp, nh * hd, h), (tp, h, 2 * inter), (tp, inter, h),
        (tp, h, dit_cfg.audio_acoustic_hidden_dim * dit_cfg.patch_size),
    }
    return sorted(qmm)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def run() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from acestep_tpu_torch import pipeline, weights
        from acestep_tpu_torch.config import DiTConfig, QwenConfig, VAEConfig
        from acestep_tpu_torch.ops.cuda import _build, qmm
        from acestep_tpu_torch.ops.cuda import vae_resunit as vru
    except ImportError as exc:
        print(f"chip_smoke: run it from the repository root ({exc})", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    phase("gpu")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    require(smi.returncode == 0 and smi.stdout.strip(), f"nvidia-smi failed: {smi.stderr}")
    smi_line = smi.stdout.strip().splitlines()[0]
    log(f"card: {smi_line}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    phase("build")
    t = time.perf_counter()
    _build.lib()
    log(f"kernels built in {time.perf_counter() - t:.1f} s "
        f"(nvcc {_build.build_seconds if _build.build_seconds is not None else 'cached'}) "
        f"-> {_build.library_path()}")

    dit_cfg, text_cfg, vae_cfg = DiTConfig(), QwenConfig(), VAEConfig()
    phase("check")
    checked = {"qmm": set(), "unit": set(), "trio": set()}
    errs = {qmm.NAME: 0.0, vru.UNIT_NAME: 0.0, vru.TRIO_NAME: 0.0}
    for i, shape in enumerate(main_path_shapes(dit_cfg, text_cfg) +
                              [(77, 2048, 200), (1, 96, 64), (129, 6144, 2048)]):
        errs[qmm.NAME] = max(errs[qmm.NAME], check_qmm(shape, i))
        checked["qmm"].add(shape)
    frames = 250       # latent frames of the 10 s clip the decoder sees
    up = vae_cfg.upsampling_ratios
    l256 = frames * up[0] * up[1] * up[2]
    for d in (1, 3, 9):
        for shape in ((1, l256, 256, d), (2, 45, 256, d)):
            errs[vru.UNIT_NAME] = max(errs[vru.UNIT_NAME], check_unit(shape, d))
            checked["unit"].add(shape)
    for shape in ((1, l256 * up[3], 128), (1, l256 * up[3] * up[4], 128), (2, 70, 128),
                  (1, 20, 128)):
        errs[vru.TRIO_NAME] = max(errs[vru.TRIO_NAME], check_trio(shape, 7))
        checked["trio"].add(shape)

    phase("engine")
    t = time.perf_counter()
    engine = pipeline.build_random_engine(device="cuda", quant="q8_0", seed=0)
    torch.cuda.synchronize()
    log(f"full-width q8_0 engine built on the card in {time.perf_counter() - t:.1f} s; "
        f"device memory {torch.cuda.memory_allocated() / 2**30:.2f} GiB")

    phase("serve")
    rng = np.random.default_rng(0)
    req = pipeline.GenerationRequest(
        duration_s=10.0, style_token_ids=rng.integers(0, 150000, (1, 64)),
        lyric_token_ids=rng.integers(0, 150000, (1, 256)), seeds=[1])
    results, counts = [], []
    for i in range(3):
        qmm.reset_counts()
        vru.reset_counts()
        res = engine.generate(req)
        n = {qmm.NAME: qmm.launches, vru.UNIT_NAME: vru.unit_launches,
             vru.TRIO_NAME: vru.trio_launches}
        shapes = {"qmm": dict(qmm.shapes), "unit": dict(vru.unit_shapes),
                  "trio": dict(vru.trio_shapes)}
        results.append(res)
        counts.append((n, shapes))
        kind = "warm-up" if i == 0 else "timed"
        log(f"request {i} ({kind}): time_costs "
            + json.dumps({k: round(v, 6) for k, v in res.time_costs.items()}))
        log(f"request {i} launches: {json.dumps(n)}")
        require(all(v > 0 for v in n.values()), f"request {i}: a kernel was not launched")
    launches, served = counts[-1]

    phase("output")
    for i, res in enumerate(results):
        a = res.audio_i16
        require(res.audio_lengths == [480000], f"audio_lengths {res.audio_lengths}")
        require(a.dtype == np.int16 and a.ndim == 3 and a.shape[0] == 1
                and a.shape[1] >= 480000 and a.shape[2] == 2, f"audio_i16 shape {a.shape}")
        require(int(a.max()) != int(a.min()), "constant audio")
        require(math.isfinite(res.audio_scale) and res.audio_scale > 0,
                f"audio_scale {res.audio_scale}")
        require(bool(np.isfinite(res.latents).all()), "non-finite latents")
    require(np.array_equal(results[1].audio_i16, results[2].audio_i16),
            "two runs of one request differ")
    log(f"audio {results[-1].audio_i16.shape} int16, scale {results[-1].audio_scale:.6g}, "
        f"std {results[-1].audio_i16.std():.1f}")
    small_dit = DiTConfig(hidden_size=256, intermediate_size=512, num_hidden_layers=2,
                          num_attention_heads=4, num_key_value_heads=2, head_dim=64,
                          in_channels=24, audio_acoustic_hidden_dim=8, sliding_window=8,
                          text_hidden_dim=128, num_lyric_encoder_hidden_layers=1)
    small_text = QwenConfig(vocab_size=512, hidden_size=128, num_hidden_layers=2,
                            num_attention_heads=2, num_key_value_heads=2,
                            intermediate_size=256, head_dim=64)
    small_vae = VAEConfig(encoder_hidden_size=16, decoder_channels=128,
                          decoder_input_channels=8, downsampling_ratios=(2, 2, 2),
                          channel_multiples=(1, 2, 4))
    cpu_eng = pipeline.build_random_engine(device="cpu", seed=3, dit_cfg=small_dit,
                                           vae_cfg=small_vae, text_cfg=small_text)
    gpu_eng = pipeline.AceStepEngine(
        weights.tree_to(cpu_eng.dit_params, "cuda"), small_dit,
        weights.tree_to(cpu_eng.vae_params, "cuda"), small_vae,
        weights.tree_to(cpu_eng.text_params, "cuda"), small_text, device="cuda")
    small_req = pipeline.GenerationRequest(
        duration_s=10.0, style_token_ids=rng.integers(0, 512, (1, 20)),
        lyric_token_ids=rng.integers(0, 512, (1, 40)), seeds=[2])
    noise = torch.randn((1, 256, 8), generator=torch.Generator().manual_seed(5))
    before = qmm.launches, vru.unit_launches, vru.trio_launches
    ref = cpu_eng.generate(small_req, noise=noise).audio.ravel().astype(np.float64)
    got = gpu_eng.generate(small_req, noise=noise).audio.ravel().astype(np.float64)
    require(all(a > b for a, b in zip((qmm.launches, vru.unit_launches, vru.trio_launches),
                                      before)), "small engine on the card missed a kernel")
    cos = float(ref @ got / (np.linalg.norm(ref) * np.linalg.norm(got)))
    snr = float(10 * np.log10(np.sum(ref ** 2) / max(np.sum((ref - got) ** 2), 1e-30)))
    log(f"small engine, card (kernels) vs CPU (plain): cosine {cos:.6f} (>= 0.999), "
        f"SNR {snr:.2f} dB (>= 26)")
    require(cos >= 0.999 and snr >= 26.0, "card and CPU disagree on the small engine")

    phase("recheck")
    for shape in served["qmm"]:
        if shape not in checked["qmm"]:
            errs[qmm.NAME] = max(errs[qmm.NAME], check_qmm(shape, 99))
    for shape in served["unit"]:
        if shape not in checked["unit"]:
            errs[vru.UNIT_NAME] = max(errs[vru.UNIT_NAME], check_unit(shape, 99))
    for shape in served["trio"]:
        if shape not in checked["trio"]:
            errs[vru.TRIO_NAME] = max(errs[vru.TRIO_NAME], check_trio(shape, 99))

    phase("timing")
    import torch.nn.functional as F

    rows = []
    tot = {"ms": 0.0, "plain": 0.0, "lib": 0.0, "bound": 0.0, "bytes": 0.0, "ops": 0.0}
    for i, (shape, cnt) in enumerate(sorted(served["qmm"].items())):
        case = QmmCase(*shape, 200 + i)
        ms = cuda_ms(lambda: qmm._launch(case.x, case.qt, None, torch.bfloat16))
        plain = cuda_ms(lambda: qmm.qmm_plain(case.x, case.qt))
        lib = cuda_ms(lambda: torch.matmul(case.x, case.wd))
        b, by = case.bound()
        log(f"  q8_0_qmm M={shape[0]} K={shape[1]} N={shape[2]} x{cnt}/request: "
            f"kernel {ms:.4f} ms, plain {plain:.4f}, library {lib:.4f}, bound {b:.4f} ({by})")
        for key, v in (("ms", ms), ("plain", plain), ("lib", lib), ("bound", b)):
            tot[key] += cnt * v
        tot["bytes" if by == "bytes" else "ops"] += cnt * b
    rows.append({"name": qmm.NAME, "route": "cuda", "source": qmm.SOURCE,
                 "replaces": qmm.REPLACES, "launches": launches[qmm.NAME],
                 "max_abs_err": errs[qmm.NAME], "ms": tot["ms"], "plain_ms": tot["plain"],
                 "bound_ms": tot["bound"],
                 "bound_by": "bytes" if tot["bytes"] >= tot["ops"] else "operations",
                 "library_ms": tot["lib"]})

    def conv_lib(x, tens, d):
        xt = x.transpose(1, 2)
        y = F.conv1d(xt, tens[0].permute(2, 1, 0), tens[1], padding=3 * d, dilation=d)
        return F.conv1d(y, tens[2].t()[:, :, None], tens[3])

    for name, src_kind in ((vru.UNIT_NAME, "unit"), (vru.TRIO_NAME, "trio")):
        tot = {"ms": 0.0, "plain": 0.0, "lib": 0.0, "bound": 0.0, "bytes": 0.0, "ops": 0.0}
        for shape, cnt in sorted(served[src_kind].items()):
            n, length, c = shape[:3]
            x = _res_x(n, length, c, 300)
            if src_kind == "unit":
                d = shape[3]
                tens = vru.unit_tensors(_unit_params(c, 300), x.device)
                ms = cuda_ms(lambda: vru.launch_unit(x, tens, d))
                plain = cuda_ms(lambda: vru.res_unit_plain(x, *tens, d))
                lib = cuda_ms(lambda: conv_lib(x, tens, d))
                b, by = res_bound(n, length, c, 1)
            else:
                st = vru.trio_tensors(tuple(_unit_params(c, 300 + j) for j in range(3)),
                                      x.device)
                per = [tuple(t[j] for t in st) for j in range(3)]
                ms = cuda_ms(lambda: vru.launch_trio(x, st))
                plain = cuda_ms(lambda: vru.res_trio_plain(x, *st))
                lib = cuda_ms(lambda: [conv_lib(x, per[j], vru.TRIO_D[j]) for j in range(3)])
                b, by = res_bound(n, length, c, 3)
            log(f"  {name} {shape} x{cnt}/request: kernel {ms:.4f} ms, plain {plain:.4f}, "
                f"library (cuDNN convs) {lib:.4f}, bound {b:.4f} ({by})")
            for key, v in (("ms", ms), ("plain", plain), ("lib", lib), ("bound", b)):
                tot[key] += cnt * v
            tot["bytes" if by == "bytes" else "ops"] += cnt * b
        rows.append({"name": name, "route": "cuda", "source": vru.SOURCE,
                     "replaces": vru.UNIT_REPLACES if src_kind == "unit" else vru.TRIO_REPLACES,
                     "launches": launches[name], "max_abs_err": errs[name],
                     "ms": tot["ms"], "plain_ms": tot["plain"], "bound_ms": tot["bound"],
                     "bound_by": "bytes" if tot["bytes"] >= tot["ops"] else "operations",
                     "library_ms": tot["lib"]})

    log("kernel times are per request: each served shape timed alone (CUDA events, "
        "warm L2) and weighted by its launches in one request")
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


def main() -> int:
    threading.Thread(target=_watchdog, daemon=True).start()
    try:
        return run()
    except Failure as exc:
        log(f"FAILED in phase '{_state['phase']}': {exc}")
        return 1


if __name__ == "__main__":
    sys.exit(main())
