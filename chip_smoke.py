#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (acestep_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each announced by a timestamped line:
  1. gpu        the card's name and power limit (nvidia-smi)
  2. build      compile csrc/*.cu with one nvcc call into build/kernels/ (ctypes)
  3. check      each kernel against its plain PyTorch version at the shapes the
                10 s and the 60 s paths launch, plus ragged M and N.  q8_0
                matmul: atol 1e-2 + rtol 1e-2 in bf16.  q4_0 / q4_k / q6_k: the
                JAX package's kernel-test bound (test_qmm_pallas.py), max error
                below 2% of the mean |output| on the f32 outputs and >= 98% of
                the bf16 outputs equal, each within one bf16 step (2^-7).  VAE
                res unit / trio: 1e-4 in f32
  4. engine     the full-width random q8_0 engine, built on the card
  5. serve      configs[0]: 10 s text2music, 64 style + 256 lyric tokens, one
                seed, through AceStepEngine.generate three times (one warm-up,
                two timed); every kernel of the path launched in each request
  6. output     audio_lengths == [480000], int16 [1, >=480000, 2], non-constant,
                finite positive scale; a small engine on the card (kernels)
                against the same engine on the CPU (plain versions): the Q8_0
                gate, cosine >= 0.999 and SNR >= 26 dB
  7. engine60   the full-width random q4_0 engine (the q8_0 engine freed first)
  8. serve60    configs[1]: the same request at 60 s, three times at q4_0
                (q4_0_qmm, q8_0_qmm, vae_res_unit and vae_res_trio launched in
                each), then once as warm-up and once timed at q4_k and at q6_k,
                one full-width engine at a time, each with its own kernel
                launched
  9. output60   audio_lengths == [2880000], int16 [1, >=2880000, 2],
                non-constant, finite positive scale; a small q4_0, q4_k and q6_k
                engine each on the card against the same engine on the CPU, at
                the Q8_0 gate
 10. checkpoint a small q4_k engine written with the port's save_params to a
                temporary directory, read back through
                serving.launch.build_engine(dir) on the card: the same int16
                output, exactly
 11. recheck    every (kernel, shape) the served requests launched that phase 3
                did not cover, against the plain version
 12. timing     kernel, plain-version and library-call times at the served
                shapes, beside the bound (bytes over 3.35 TB/s or operations
                over 989 TFLOP/s bf16 / 67 TFLOP/s f32)
Then one {"kernels": [...]} line, the nvidia-smi line, and last the result line.
A watchdog ends the run with a non-zero code, naming the phase that overran.
Without a card, or outside the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time

WATCHDOG_S = 1100          # whole run, the kernels' build included (limit 1200 s)
QMM_ATOL, QMM_RTOL = 1e-2, 1e-2
Q4_REL_MAX, Q4_EQUAL_MIN = 0.02, 0.98
RES_TOL = 1e-4
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
FOUR_BIT = ("q4_0", "q4_k", "q6_k")

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
    """A random weight [K, N] quantized to ``fmt`` (f32 scales, as the engine
    keeps them) and activations [M, K] on the card."""

    def __init__(self, fmt, m, k, n, seed):
        import torch
        from acestep_tpu_torch.ops.qlinear import precast_quant_scales
        from acestep_tpu_torch.quant import dequantize, quantize

        g = torch.Generator(device="cuda").manual_seed(seed)
        stored = quantize(torch.randn((k, n), generator=g, device="cuda") * 0.02, fmt)
        # the bound counts the weight as the format stores it (f16 scales); the
        # kernels' f32 scale stream is overhead the bound does not grant them
        self.weight_bytes = stored.nbytes
        self.qt = precast_quant_scales(stored)
        self.x = torch.randn((m, k), generator=g, device="cuda").bfloat16()
        self.wd = dequantize(self.qt, torch.bfloat16)
        self.m, self.k, self.n = m, k, n

    def bound(self):
        m, k, n = self.m, self.k, self.n
        return bound_ms(m * k * 2 + self.weight_bytes + m * n * 2, 2.0 * m * k * n, BF16_FLOPS)


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


def check_qmm(fmt, shape, seed) -> float:
    """The format's kernel against its plain version on one shape; returns the
    max abs error of the bf16 outputs."""
    import torch
    from acestep_tpu_torch.ops.cuda import qmm

    case = QmmCase(fmt, *shape, seed)
    name = f"{qmm.KERNELS[fmt].name} M={shape[0]} K={shape[1]} N={shape[2]}"
    got = qmm._launch(case.x, case.qt, None, torch.bfloat16)
    ref = qmm.qmm_plain(case.x, case.qt)
    if fmt == "q8_0":
        return check_close(name, got, ref, QMM_ATOL, QMM_RTOL)
    got32 = qmm._launch(case.x, case.qt, None, torch.float32)
    ref32 = qmm.qmm_plain(case.x, case.qt, None, torch.float32)
    require(bool(torch.isfinite(got32).all() and torch.isfinite(got.float()).all()),
            f"{name}: non-finite kernel output")
    rel = float((got32 - ref32).abs().max() / ref32.abs().mean())
    g, r = got.float(), ref.float()
    equal = float((g == r).float().mean())
    one_step = bool(((g - r).abs() <= 2.0 ** -7 * r.abs() + 1e-4 * r.abs().mean()).all())
    ok = rel < Q4_REL_MAX and equal > Q4_EQUAL_MIN and one_step
    err = max_err(got, ref)
    log(f"  {name}: f32 max err / mean|ref| {rel:.2e} (< {Q4_REL_MAX}), bf16 equal "
        f"{equal:.5f} (> {Q4_EQUAL_MIN}), within one bf16 step {one_step}, "
        f"max_abs_err {err:.3e} {'ok' if ok else 'FAIL'}")
    require(ok, f"{name}: kernel disagrees with its plain version")
    return err


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
    """The quantized matmul shapes (M, K, N) a batch-1 request with ``frames``
    bucketed latent frames launches (from the configs; 256 frames = 10 s,
    1536 = 60 s)."""
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


def shapes_by_kernel(fmt, shapes):
    """{kernel format: shapes} of an engine quantized to ``fmt`` (a 4-bit
    format keeps q8_0 where K % 256 != 0)."""
    from acestep_tpu_torch.quant import supported_format_for

    out = {}
    for shape in shapes:
        out.setdefault(supported_format_for(shape[1], fmt), []).append(shape)
    return out


def snapshot_counts():
    """(launches by kernel name, shapes by kernel name) since the last reset."""
    from acestep_tpu_torch.ops.cuda import qmm
    from acestep_tpu_torch.ops.cuda import vae_resunit as vru

    n = {k.name: k.launches for k in qmm.KERNELS.values()}
    n[vru.UNIT_NAME], n[vru.TRIO_NAME] = vru.unit_launches, vru.trio_launches
    shapes = {k.name: dict(k.shapes) for k in qmm.KERNELS.values()}
    shapes[vru.UNIT_NAME], shapes[vru.TRIO_NAME] = dict(vru.unit_shapes), dict(vru.trio_shapes)
    return n, shapes


def serve(engine, req, label, n_requests, need):
    """``n_requests`` of ``req`` (the first a warm-up), the counts reset just
    before each and read just after; every kernel named in ``need`` must launch
    in each.  Returns the results and the last request's (launches, shapes)."""
    from acestep_tpu_torch.ops.cuda import qmm
    from acestep_tpu_torch.ops.cuda import vae_resunit as vru

    results, counts = [], None
    for i in range(n_requests):
        qmm.reset_counts()
        vru.reset_counts()
        res = engine.generate(req)
        counts = snapshot_counts()
        results.append(res)
        kind = "warm-up" if i == 0 else "timed"
        log(f"{label} request {i} ({kind}): time_costs "
            + json.dumps({k: round(v, 6) for k, v in res.time_costs.items()}))
        log(f"{label} request {i} launches: "
            + json.dumps({k: v for k, v in counts[0].items() if v}))
        require(all(counts[0][name] > 0 for name in need),
                f"{label} request {i}: a kernel of the path was not launched "
                f"(need {need})")
    return results, counts


def check_audio(results, length):
    import numpy as np

    for res in results:
        a = res.audio_i16
        require(res.audio_lengths == [length], f"audio_lengths {res.audio_lengths}")
        require(a.dtype == np.int16 and a.ndim == 3 and a.shape[0] == 1
                and a.shape[1] >= length and a.shape[2] == 2, f"audio_i16 shape {a.shape}")
        require(int(a.max()) != int(a.min()), "constant audio")
        require(math.isfinite(res.audio_scale) and res.audio_scale > 0,
                f"audio_scale {res.audio_scale}")
        require(bool(np.isfinite(res.latents).all()), "non-finite latents")
    log(f"audio {results[-1].audio_i16.shape} int16, scale {results[-1].audio_scale:.6g}, "
        f"std {results[-1].audio_i16.std():.1f}")


def free_engine() -> None:
    import torch

    gc.collect()
    torch.cuda.empty_cache()


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
        from acestep_tpu_torch import loader, pipeline, weights
        from acestep_tpu_torch.config import DiTConfig, QwenConfig, VAEConfig
        from acestep_tpu_torch.ops.cuda import _build, qmm
        from acestep_tpu_torch.ops.cuda import vae_resunit as vru
        from acestep_tpu_torch.serving import launch
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
    names = {fmt: k.name for fmt, k in qmm.KERNELS.items()}
    unit, trio = vru.UNIT_NAME, vru.TRIO_NAME
    phase("check")
    checked = {name: set() for name in list(names.values()) + [unit, trio]}
    errs = {name: 0.0 for name in checked}

    def qcheck(fmt, shape, seed):
        errs[names[fmt]] = max(errs[names[fmt]], check_qmm(fmt, shape, seed))
        checked[names[fmt]].add(shape)

    for i, shape in enumerate(main_path_shapes(dit_cfg, text_cfg) +
                              [(77, 2048, 200), (1, 96, 64), (129, 6144, 2048)]):
        qcheck("q8_0", shape, i)
    shapes60 = main_path_shapes(dit_cfg, text_cfg, frames=1536)
    for fmt in FOUR_BIT:
        by_kernel = shapes_by_kernel(fmt, shapes60)
        for kfmt, shapes in sorted(by_kernel.items()):
            extra = [(77, 2048, 200), (5, 512, 40)] if kfmt == fmt else []
            for i, shape in enumerate(shapes + extra):
                if shape not in checked[names[kfmt]]:
                    qcheck(kfmt, shape, 1000 + i)
    frames = 250       # latent frames of the 10 s clip the decoder sees
    up = vae_cfg.upsampling_ratios
    l256 = frames * up[0] * up[1] * up[2]
    for d in (1, 3, 9):
        for shape in ((1, l256, 256, d), (2, 45, 256, d)):
            errs[unit] = max(errs[unit], check_unit(shape, d))
            checked[unit].add(shape)
    for shape in ((1, l256 * up[3], 128), (1, l256 * up[3] * up[4], 128), (2, 70, 128),
                  (1, 20, 128)):
        errs[trio] = max(errs[trio], check_trio(shape, 7))
        checked[trio].add(shape)

    phase("engine")
    t = time.perf_counter()
    engine = pipeline.build_random_engine(device="cuda", quant="q8_0", seed=0)
    torch.cuda.synchronize()
    log(f"full-width q8_0 engine built on the card in {time.perf_counter() - t:.1f} s; "
        f"device memory {torch.cuda.memory_allocated() / 2**30:.2f} GiB")

    phase("serve")
    rng = np.random.default_rng(0)
    style, lyric = rng.integers(0, 150000, (1, 64)), rng.integers(0, 150000, (1, 256))
    req = pipeline.GenerationRequest(duration_s=10.0, style_token_ids=style,
                                     lyric_token_ids=lyric, seeds=[1])
    path10 = [names["q8_0"], unit, trio]
    results, served = {}, {}
    results["10s"], served["10s"] = serve(engine, req, "configs[0] q8_0", 3, path10)

    phase("output")
    check_audio(results["10s"], 480000)
    require(np.array_equal(results["10s"][1].audio_i16, results["10s"][2].audio_i16),
            "two runs of one request differ")
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
    small_rng = np.random.default_rng(1)
    small_req = pipeline.GenerationRequest(
        duration_s=10.0, style_token_ids=small_rng.integers(0, 512, (1, 20)),
        lyric_token_ids=small_rng.integers(0, 512, (1, 40)), seeds=[2])
    noise = torch.randn((1, 256, 8), generator=torch.Generator().manual_seed(5))

    def card_vs_cpu(quant, need):
        cpu_eng = pipeline.build_random_engine(device="cpu", quant=quant, seed=3,
                                               dit_cfg=small_dit, vae_cfg=small_vae,
                                               text_cfg=small_text)
        gpu_eng = pipeline.AceStepEngine(
            weights.tree_to(cpu_eng.dit_params, "cuda"), small_dit,
            weights.tree_to(cpu_eng.vae_params, "cuda"), small_vae,
            weights.tree_to(cpu_eng.text_params, "cuda"), small_text, device="cuda")
        before = snapshot_counts()[0]
        ref = cpu_eng.generate(small_req, noise=noise).audio.ravel().astype(np.float64)
        got = gpu_eng.generate(small_req, noise=noise).audio.ravel().astype(np.float64)
        after = snapshot_counts()[0]
        require(all(after[n] > before[n] for n in need),
                f"small {quant} engine on the card missed a kernel of {need}")
        cos = float(ref @ got / (np.linalg.norm(ref) * np.linalg.norm(got)))
        snr = float(10 * np.log10(np.sum(ref ** 2) / max(np.sum((ref - got) ** 2), 1e-30)))
        log(f"small {quant} engine, card (kernels) vs CPU (plain): cosine {cos:.6f} "
            f"(>= 0.999), SNR {snr:.2f} dB (>= 26)")
        require(cos >= 0.999 and snr >= 26.0, f"card and CPU disagree on the small "
                f"{quant} engine")

    card_vs_cpu("q8_0", path10)

    phase("engine60")
    del engine
    free_engine()
    t = time.perf_counter()
    engine = pipeline.build_random_engine(device="cuda", quant="q4_0", seed=0)
    torch.cuda.synchronize()
    memory = {"q4_0": torch.cuda.memory_allocated() / 2**30}
    log(f"full-width q4_0 engine built on the card in {time.perf_counter() - t:.1f} s; "
        f"device memory {memory['q4_0']:.2f} GiB")

    phase("serve60")
    req60 = pipeline.GenerationRequest(duration_s=60.0, style_token_ids=style,
                                       lyric_token_ids=lyric, seeds=[1])
    results["60s q4_0"], served["60s q4_0"] = serve(
        engine, req60, "configs[1] q4_0", 3, [names["q4_0"], names["q8_0"], unit, trio])
    require(np.array_equal(results["60s q4_0"][1].audio_i16, results["60s q4_0"][2].audio_i16),
            "two runs of the 60 s request differ")
    for fmt in ("q4_k", "q6_k"):
        del engine
        free_engine()
        t = time.perf_counter()
        engine = pipeline.build_random_engine(device="cuda", quant=fmt, seed=0)
        torch.cuda.synchronize()
        memory[fmt] = torch.cuda.memory_allocated() / 2**30
        log(f"full-width {fmt} engine built on the card in {time.perf_counter() - t:.1f} s; "
            f"device memory {memory[fmt]:.2f} GiB")
        results[f"60s {fmt}"], served[f"60s {fmt}"] = serve(
            engine, req60, f"configs[1] at {fmt}", 2, [names[fmt], unit, trio])
    del engine
    free_engine()

    phase("output60")
    for key in ("60s q4_0", "60s q4_k", "60s q6_k"):
        check_audio(results[key], 1500 * vae_cfg.hop_length)
    for fmt in FOUR_BIT:
        card_vs_cpu(fmt, [names[fmt], unit, trio])

    phase("checkpoint")
    src = pipeline.build_random_engine(device="cuda", quant="q4_k", seed=4,
                                       dit_cfg=small_dit, vae_cfg=small_vae,
                                       text_cfg=small_text)
    before = src.generate(small_req)
    with tempfile.TemporaryDirectory(prefix="acestep_ckpt_") as ckpt:
        for name, params, cfg in (("dit", src.dit_params, small_dit),
                                  ("vae", src.vae_params, small_vae),
                                  ("text_encoder", src.text_params, small_text)):
            loader.save_params(os.path.join(ckpt, name), params)
            with open(os.path.join(ckpt, f"{name}.config.json"), "w") as f:
                json.dump(dataclasses.asdict(cfg), f)
        size = sum(os.path.getsize(os.path.join(ckpt, p)) for p in os.listdir(ckpt))
        launches_before = qmm.KERNELS["q4_k"].launches
        loaded = launch.build_engine(ckpt, device="cuda")
        after = loaded.generate(small_req)
    require(qmm.KERNELS["q4_k"].launches > launches_before,
            "the loaded engine did not run the q4_k kernel")
    same = (np.array_equal(before.audio_i16, after.audio_i16)
            and before.audio_scale == after.audio_scale)
    log(f"q4_k checkpoint ({size} bytes) saved, read back through build_engine: int16 "
        f"output {'identical' if same else 'DIFFERENT'}")
    require(same, "the checkpoint round trip changed the output")

    phase("recheck")
    for key, (_, shapes) in served.items():
        for fmt, name in names.items():
            for shape in shapes[name]:
                if shape not in checked[name]:
                    qcheck(fmt, shape, 99)
        for shape in shapes[unit]:
            if shape not in checked[unit]:
                errs[unit] = max(errs[unit], check_unit(shape, 99))
                checked[unit].add(shape)
        for shape in shapes[trio]:
            if shape not in checked[trio]:
                errs[trio] = max(errs[trio], check_trio(shape, 99))
                checked[trio].add(shape)

    phase("timing")
    import torch.nn.functional as F

    def conv_lib(x, tens, d):
        xt = x.transpose(1, 2)
        y = F.conv1d(xt, tens[0].permute(2, 1, 0), tens[1], padding=3 * d, dilation=d)
        return F.conv1d(y, tens[2].t()[:, :, None], tens[3])

    def time_qmm(fmt, counts):
        tot = {"ms": 0.0, "plain": 0.0, "lib": 0.0, "bound": 0.0, "bytes": 0.0, "ops": 0.0}
        for i, (shape, cnt) in enumerate(sorted(counts.items())):
            case = QmmCase(fmt, *shape, 200 + i)
            ms = cuda_ms(lambda: qmm._launch(case.x, case.qt, None, torch.bfloat16))
            plain = cuda_ms(lambda: qmm.qmm_plain(case.x, case.qt))
            lib = cuda_ms(lambda: torch.matmul(case.x, case.wd))
            b, by = case.bound()
            log(f"  {names[fmt]} M={shape[0]} K={shape[1]} N={shape[2]} x{cnt}/request: "
                f"kernel {ms:.4f} ms, plain {plain:.4f}, library {lib:.4f}, "
                f"bound {b:.4f} ({by})")
            for key, v in (("ms", ms), ("plain", plain), ("lib", lib), ("bound", b)):
                tot[key] += cnt * v
            tot["bytes" if by == "bytes" else "ops"] += cnt * b
        return tot

    def time_res(kind, counts):
        tot = {"ms": 0.0, "plain": 0.0, "lib": 0.0, "bound": 0.0, "bytes": 0.0, "ops": 0.0}
        for shape, cnt in sorted(counts.items()):
            n, length, c = shape[:3]
            x = _res_x(n, length, c, 300)
            if kind == unit:
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
            log(f"  {kind} {shape} x{cnt}/request: kernel {ms:.4f} ms, plain {plain:.4f}, "
                f"library (cuDNN convs) {lib:.4f}, bound {b:.4f} ({by})")
            for key, v in (("ms", ms), ("plain", plain), ("lib", lib), ("bound", b)):
                tot[key] += cnt * v
            tot["bytes" if by == "bytes" else "ops"] += cnt * b
        return tot

    def timed(name, path):
        log(f"{name} on the {path} path:")
        counts = served[path][1][name]
        fmt = next((f for f, n in names.items() if n == name), None)
        tot = time_qmm(fmt, counts) if fmt else time_res(name, counts)
        log(f"{name} per {path} request: kernel {tot['ms']:.4f} ms, plain "
            f"{tot['plain']:.4f}, library {tot['lib']:.4f}, bound {tot['bound']:.4f}")
        return tot

    # each kernel's row from the path that introduced it; the other paths' totals
    # are logged for the phase split
    rows = []
    row_paths = ((names["q8_0"], "10s", qmm.KERNELS["q8_0"].source,
                  qmm.KERNELS["q8_0"].replaces),
                 (unit, "10s", vru.SOURCE, vru.UNIT_REPLACES),
                 (trio, "10s", vru.SOURCE, vru.TRIO_REPLACES))
    row_paths += tuple((names[fmt], f"60s {fmt}", qmm.KERNELS[fmt].source,
                        qmm.KERNELS[fmt].replaces) for fmt in FOUR_BIT)
    for name, path, source, replaces in row_paths:
        tot = timed(name, path)
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": served[path][0][name],
                     "max_abs_err": errs[name], "ms": tot["ms"], "plain_ms": tot["plain"],
                     "bound_ms": tot["bound"],
                     "bound_by": "bytes" if tot["bytes"] >= tot["ops"] else "operations",
                     "library_ms": tot["lib"]})
    for name in (names["q8_0"], unit, trio):
        timed(name, "60s q4_0")
    log("device memory of the full-width engines (GiB): "
        + json.dumps({k: round(v, 3) for k, v in memory.items()}))
    log("kernel times are per request: each served shape timed alone (CUDA events, "
        "warm L2) and weighted by its launches in one request of the named path")
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
