#!/usr/bin/env python3
"""Drive the PyTorch port (pdm_tpu_torch) on one NVIDIA GPU and check it.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It needs one CUDA card, nvcc (CUDA_HOME or /usr/local/cuda) and nothing of
the JAX package. Phases, each of which fails the run (non-zero exit) on
any error or disagreement:

1. The card's name and power limit, torch and CUDA versions, and the
   build of every kernel from pdm_tpu_torch/csrc/ (nvcc, sm_90a).
2. Every kernel of the main path at every shape the flagship UNet gives
   it, against its plain PyTorch version on the same card inputs, with
   the tolerance stated; times beside the bound and one library call as a
   yardstick. A time is the card's (CUDA events, median of repetitions,
   warm L2, the host's enqueue hidden behind a sleep kernel); the host's
   own cost per call is reported beside it.
3. The full-width flagship UNet in fp32 on the card (kernels) against the
   same weights on the CPU (plain versions) at batch 2, and a 10-step
   fp32 DDIM sample on both from the same starting noise.
4. The main path: the bf16 flagship (seeded random weights, std 0.02) in
   DDPMSampler(step_type="ddpm", n_steps=1000, batch_size=64,
   precision="half") on LinearBetaScheduler(1e-4, 2.478e4). The launch
   counters are zeroed just before and read just after; each kernel must
   have launched exactly its per-forward count times 1000. Then the card's
   busy time for one model evaluation against the step's wall time, and a
   torch.profiler trace of 20 more steps: the card's time per step by
   kernel and by kind of kernel.
5. The backward kernels at every shape the flagship's training step
   gives them (batch 128, bf16, and fp32 for attention), and the forward
   kernels at the training batch, against their plain versions, with
   times beside the bound, the plain version and one library call's
   backward alone (torch.autograd.grad over scaled_dot_product_attention,
   and over group_norm then silu).
6. The full-width fp32 flagship train step (batch 2, dropout off, the
   same tau and eps) on the card against the CPU: loss and every
   gradient the step applied within the stated tolerance of their scale,
   then the parameters after that Adam step.
7. The training main path: the bf16 flagship with fp32 master weights in
   DDPMTrainer(lr 1e-4, warmup 10, total 1000, clip 1.0, EMA 0.9999), as
   bench.py's train step, at batch 128 of N(0, 1) CIFAR-shaped data from a
   seed with dropout 0.2. Warm steps, then timed steps with the launch
   counters zeroed just before and read just after: each of the four
   kernels must have launched exactly its per-step count. Loss and
   grad_norm finite; the card's busy time per step against the wall time;
   a torch.profiler breakdown; a checkpoint saved, resumed into a fresh
   trainer (the resumed state equal to the saved one) and one more step.
8. One JSON line {"kernels": [...]} with all four kernels, then the last
   line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

# H100 SXM data sheet (dense): bytes/s of HBM3, operations/s by type
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}

N_STEPS = 1000
BATCH = 64
PROFILE_STEPS = 20  # main-path steps traced for the time breakdown
FLAGSHIP = {
    "freq_shift": 1, "flip_sin_to_cos": False,
    "down_block_types": ["DownBlock2D", "AttnDownBlock2D", "DownBlock2D",
                         "DownBlock2D"],
    "up_block_types": ["UpBlock2D", "UpBlock2D", "AttnUpBlock2D", "UpBlock2D"],
    "block_out_channels": [128, 256, 256, 256],
    "downsample_padding": 0, "attention_head_dim": 64,
    "dropout": 0.2, "norm_eps": 1e-6, "layers_per_block": 3,
}
# tolerances of kernel vs plain version on the same card inputs:
# fp32 differs by summation order only; bf16 outputs may differ by one
# rounding step of the output (ulp / |value| <= 2^-7 for bf16)
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-2, 2e-3)}  # (rtol, atol)
FORWARD_TOL = 1e-3  # fp32 UNet forward / DDIM sample, card vs CPU, of scale
# backward kernel vs plain version, (rtol, atol as a fraction of the
# tensor's max |value|): fp32 by summation order; bf16 by one rounding step
# of an output or of a rounded P / ds inside the kernel
BWD_TOL = {"float32": (1e-4, 1e-5), "bfloat16": (2 ** -7, 2 ** -8)}
PARAM_GRAD_TOL = (1e-4, 1e-4)  # dscale / dbias: fp32 sums over B and S
# fp32 train step, card vs CPU: loss relative; each gradient 1e-3 of its
# own scale plus 1e-5 of the largest gradient's (to_k.bias's gradient is
# zero in exact arithmetic); the Adam step below
TRAIN_TOL = {"loss": 1e-4, "grad": 1e-3, "grad_floor": 1e-5}
TRAIN_BATCH = 128  # bench.py's train step
TRAIN_WARM = 3
TRAIN_STEPS = 30
TRAIN_PROFILE_STEPS = 5
# per-step calls on the training path: 8 attention and 69 GroupNorm layers,
# each once forward and once backward; attention's backward is two kernels
TRAIN_LAUNCHES = {"attention_fwd": 8, "attention_bwd": 16,
                  "group_norm_fwd": 69, "group_norm_bwd": 69}
# operations per element of the GroupNorm backward (fp32), over its three
# passes: statistics 3, normalizing twice 4, partials 3, dx 6; the SiLU
# VJP (~10) is taken twice
GN_BWD_OPS = {"silu": 36, "none": 16}


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def make_timer(cycles_per_ms: float):
    """A function timing `fn` on the card: (device ms, host ms) per call,
    medians over `reps` runs of `inner` back-to-back calls.

    The device time comes from CUDA events around the calls. A sleep kernel
    queued just before them holds the stream while the host enqueues the
    calls, so the host's own cost per call (returned beside it) does not
    show in the device time; a run whose enqueue outlasted the sleep is
    repeated with a longer sleep. L2 stays warm between calls."""
    import torch

    def time_ms(fn, reps: int = 10, inner: int = 20):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        sleep_ms, dev, host, tries = 10.0, [], [], 0
        while len(dev) < reps:
            tries += 1
            if tries > reps + 3:
                fail("timing: the enqueue keeps outlasting the sleep kernel "
                     "(a host sync inside the timed call?)")
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(int(sleep_ms * cycles_per_ms))
            a.record()
            t0 = time.perf_counter()
            for _ in range(inner):
                fn()
            enqueue_ms = (time.perf_counter() - t0) * 1e3
            b.record()
            torch.cuda.synchronize()
            if enqueue_ms > 0.8 * sleep_ms:
                sleep_ms = 2.0 * enqueue_ms
                continue
            dev.append(a.elapsed_time(b) / inner)
            host.append(enqueue_ms / inner)
        return statistics.median(dev), statistics.median(host)

    return time_ms


def sleep_rate() -> float:
    """Cycles of torch.cuda._sleep per millisecond on this card."""
    import torch

    cycles = 20_000_000
    torch.cuda._sleep(cycles // 10)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    torch.cuda._sleep(cycles)
    b.record()
    torch.cuda.synchronize()
    return cycles / a.elapsed_time(b)


def bound(n_bytes: float, n_ops: float, dtype: str):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(got, want, dtype: str):
    rtol, atol = TOL[dtype]
    diff = (got.float() - want.float()).abs()
    ok = bool((diff <= atol + rtol * want.float().abs()).all())
    return float(diff.max()), ok, rtol, atol


def compare_to_scale(got, want, rtol: float, atol_of_scale: float):
    """(max abs error, ok) for |got - want| <= rtol |want| + atol_of_scale
    * max |want|."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    bound_t = rtol * want.abs() + atol_of_scale * float(want.abs().max())
    return float(diff.max()), bool((diff <= bound_t).all())


def adam_first_step_bound(g_a, g_b, lr: float, eps: float = 1e-8):
    """The most two first Adam steps (update lr * g / (|g| + eps), weight
    decay 0) can differ by, elementwise, for gradients g_a and g_b: near
    g = 0 a gradient that changes sign moves the update by up to 2 lr."""
    import torch

    diff = (g_a - g_b).abs()
    return lr * torch.clamp(
        2 * diff / (torch.maximum(g_a.abs(), g_b.abs()) + eps), max=2.0)


def train_step_with_grads(trainer, state, x0, **kwargs):
    """``trainer.train_step``, returning also the fp32 gradients that step
    applied (before clipping) as CPU copies keyed by parameter name.
    Checks of the step's parameters use these, not the gradients of
    another backward pass: Adam's first step moves an element by up to
    2 lr when its gradient changes by a rounding step."""
    grads_of = trainer._grads
    names = [k for k, _ in trainer.ddpm.module.named_parameters()]
    seen = {}

    def record(*args):
        loss, grads = grads_of(*args)
        seen.update({k: g.to("cpu", copy=True) for k, g in zip(names, grads)})
        return loss, grads

    trainer._grads = record
    try:
        state, metrics = trainer.train_step(state, x0, **kwargs)
    finally:
        del trainer._grads
    return state, metrics, seen


def seeded_state_dict(net, seed: int = 0, std: float = 0.02):
    """Random weights from a seed, every parameter N(0, std^2), in state
    dict order (as bench.py fills the JAX flagship)."""
    import torch

    rng = np.random.RandomState(seed)
    return {k: torch.from_numpy(
                (rng.standard_normal(tuple(v.shape)) * std).astype(np.float32))
            for k, v in net.state_dict().items()}


def profile_steps(run, n_steps: int, label: str = "profile") -> float:
    """Print the card's kernel time per main-path step, by kernel and by
    kind, from a torch.profiler trace of `run` (n_steps steps); returns
    the card's busy ms per step under the profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    per_kernel = {}
    for e in prof.events():
        # kernels only: a GPU-side user annotation (Optimizer.step's range)
        # spans kernels already counted
        if (e.device_type == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            ms, n = per_kernel.get(e.name, (0.0, 0))
            per_kernel[e.name] = (ms + e.device_time_total / 1e3, n + 1)
    kinds = (("attention kernel", ("attention_fwd",)),
             ("attention backward kernels", ("attention_bwd",)),
             ("GroupNorm kernel", ("group_norm_fwd",)),
             ("GroupNorm backward kernel", ("group_norm_bwd",)),
             ("convolution", ("conv", "fprop", "dgrad", "wgrad", "nhwc",
                              "nchw")),
             ("matmul", ("gemm", "cutlass", "cublas", "nvjet")),
             ("optimizer (foreach)", ("foreach", "multi_tensor")))
    by_kind = {name: [0.0, 0] for name, _ in kinds}
    by_kind["other"] = [0.0, 0]
    for kname, (ms, n) in per_kernel.items():
        kind = next((name for name, keys in kinds
                     if any(key in kname.lower() for key in keys)), "other")
        by_kind[kind][0] += ms
        by_kind[kind][1] += n
    busy = sum(ms for ms, _ in per_kernel.values())
    log(f"{label}: {n_steps} steps, {wall_ms / n_steps:.3f} ms/step wall "
        f"under the profiler, card busy {busy / n_steps:.3f} ms/step "
        f"({busy / wall_ms:.1%}), "
        f"{sum(n for _, n in per_kernel.values()) / n_steps:g} launches/step")
    for kind, (ms, n) in sorted(by_kind.items(), key=lambda kv: -kv[1][0]):
        log(f"{label}: {kind}: {ms / n_steps:.4f} ms/step, {n / n_steps:g} "
            f"launches/step")
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:15]
    for kname, (ms, n) in top:
        log(f"{label} kernel: {ms / n_steps:.4f} ms/step x{n / n_steps:g} "
            f"{kname[:110]}")
    return busy / n_steps


def main() -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from pdm_tpu_torch.diffusion.sampling import DDPMSampler
    from pdm_tpu_torch.diffusion.trainer import DDPMTrainer, step_generator
    from pdm_tpu_torch.models.unet import (
        AttentionBlock, GroupNormAct, unet_from_config,
    )
    from pdm_tpu_torch.models.unet_ddpm import UNetDDPM
    from pdm_tpu_torch.ops import _build
    from pdm_tpu_torch.ops import attention as attn_op
    from pdm_tpu_torch.ops import groupnorm as gn_op
    from pdm_tpu_torch.schedulers.analytic import LinearBetaScheduler

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    # ---- phase 1: card, versions, build ----
    log(f"phase 1 at {time.perf_counter() - t_start:.1f} s")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    _build.load_kernels()
    build_s = time.perf_counter() - t0
    regs = [ln.split("ptxas info    : ")[-1] for ln in _build.build_info["log"]
            if "registers" in ln]
    spills = [ln for ln in _build.build_info["log"]
              if "spill" in ln and " 0 bytes spill stores" not in ln]
    log(f"build: {build_s:.2f} s, {len(regs)} kernel instantiations "
        f"(sm_90a) into {_build.build_info['library']}; "
        f"registers per thread {sorted({r.split()[1] for r in regs})}; "
        f"spills: {spills or 'none'}")

    time_ms = make_timer(sleep_rate())

    # shapes the main path gives each kernel: one CPU forward of the
    # full-width flagship with hooks (also phase 3's CPU reference)
    sched = LinearBetaScheduler(1e-4, 2.478e4)
    cpu_net = unet_from_config(3, FLAGSHIP, dtype=torch.float32, device="cpu")
    weights = seeded_state_dict(cpu_net)
    cpu_net.load_state_dict(weights)
    gn_calls, attn_calls = {}, {}

    def gn_hook(mod, args):
        _, C, H, W = args[0].shape
        key = (H * W, C, mod.act)
        gn_calls[key] = gn_calls.get(key, 0) + 1

    def attn_hook(mod, args):
        _, C, H, W = args[0].shape
        key = (H * W, C, mod.heads)
        attn_calls[key] = attn_calls.get(key, 0) + 1

    hooks = []
    for m in cpu_net.modules():
        if isinstance(m, GroupNormAct):
            hooks.append(m.register_forward_pre_hook(gn_hook))
        elif isinstance(m, AttentionBlock):
            hooks.append(m.register_forward_pre_hook(attn_hook))
    rng = np.random.RandomState(1)
    x_small = torch.from_numpy(rng.standard_normal((2, 3, 32, 32)).astype(np.float32))
    tau_small = torch.tensor([0.3, 0.7])
    with torch.no_grad():
        ref_out = cpu_net(x_small, tau_small)
    for h in hooks:
        h.remove()
    gn_per_fwd = sum(gn_calls.values())
    attn_per_fwd = sum(attn_calls.values())
    log(f"flagship forward: {attn_per_fwd} attention launches "
        f"({len(attn_calls)} shapes), {gn_per_fwd} GroupNorm launches "
        f"({len(gn_calls)} distinct (S, C, act))")
    if (attn_per_fwd, gn_per_fwd) != (8, 69):
        fail(f"expected 8 attention and 69 GroupNorm calls per forward, got "
             f"{attn_per_fwd} and {gn_per_fwd}")

    # ---- phase 2: each kernel vs its plain version at the flagship shapes ----
    log(f"phase 2 at {time.perf_counter() - t_start:.1f} s")
    g = torch.Generator(device=dev).manual_seed(0)

    def attention_fwd_rows(batch, dtypes):
        rows = []
        for dtype in dtypes:
            dname = str(dtype).split(".")[1]
            for (T, C, heads), calls in sorted(attn_calls.items(), reverse=True):
                qkv = torch.randn(batch, T, 3 * C, generator=g, device=dev).to(dtype)
                q, k, v = qkv.split(C, dim=-1)  # the UNet's layout: rows 3C apart
                scale = 1.0 / math.sqrt(C // heads)
                out, lse = attn_op.attention_with_lse(q, k, v, heads, scale)
                ref, ref_lse = attn_op._reference_with_lse(q, k, v, heads, scale)
                torch.cuda.synchronize()
                err, ok, rtol, atol = compare(out, ref, dname)
                lse_err = float((lse - ref_lse).abs().max())
                ok = ok and lse_err <= 1e-4 * (1.0 + float(ref_lse.abs().max()))
                hd = C // heads
                qh, kh, vh = (t.view(batch, T, heads, hd).transpose(1, 2)
                              for t in (q, k, v))
                esz = qkv.element_size()
                b_ms, b_by = bound(4 * batch * T * C * esz + batch * heads * T * 4,
                                   4 * batch * T * T * C, dname)
                ms, host_ms = time_ms(
                    lambda: attn_op.attention_with_lse(q, k, v, heads, scale))
                row = {
                    "shape": [batch, T, C], "heads": heads, "dtype": dname,
                    "calls_per_step": calls if dtype == torch.bfloat16 else 0,
                    "max_abs_err": err, "lse_max_abs_err": lse_err,
                    "rtol": rtol, "atol": atol, "ms": ms, "host_ms": host_ms,
                    "plain_ms": time_ms(lambda: attn_op._reference_with_lse(
                        q, k, v, heads, scale), inner=5)[0],
                    "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                        qh, kh, vh, scale=scale))[0],
                    "bound_ms": b_ms, "bound_by": b_by,
                }
                rows.append(row)
                log(f"attention {dname} B={batch} T={T} C={C} heads={heads}: "
                    f"max_abs_err {err:.3g} (lse {lse_err:.3g}; tol rtol {rtol} "
                    f"atol {atol}) kernel_ms {ms:.4f} (host {host_ms:.4f}) plain_ms "
                    f"{row['plain_ms']:.4f} library_ms {row['library_ms']:.4f} "
                    f"bound_ms {b_ms:.4f} ({b_by}) {'ok' if ok else 'MISMATCH'}")
                if not ok:
                    fail(f"attention kernel disagrees with its plain version at "
                         f"{row['shape']} {dname}")
        return rows

    def group_norm_fwd_rows(batch):
        rows = []
        for (S, C, act), calls in sorted(gn_calls.items(), reverse=True):
            x = torch.randn(batch, S, C, generator=g, device=dev).bfloat16()
            scale = 1.0 + 0.2 * torch.randn(C, generator=g, device=dev)
            bias = 0.1 * torch.randn(C, generator=g, device=dev)
            y = gn_op.fused_group_norm_act(x, scale, bias, 32, 1e-6, act)
            ref = gn_op.group_norm_reference(x, scale, bias, 32, 1e-6, act).bfloat16()
            torch.cuda.synchronize()
            err, ok, rtol, atol = compare(y, ref, "bfloat16")
            side = int(round(math.sqrt(S)))
            x4 = x.view(batch, side, side, C).permute(0, 3, 1, 2)  # channels_last
            sc_b, bi_b = scale.bfloat16(), bias.bfloat16()

            def library(x4=x4, sc_b=sc_b, bi_b=bi_b, act=act):
                z = F.group_norm(x4, 32, sc_b, bi_b, 1e-6)
                return F.silu(z) if act == "silu" else z

            b_ms, b_by = bound(2 * batch * S * C * 2 + 2 * C * 4,
                               (12 if act == "silu" else 8) * batch * S * C,
                               "float32")
            ms, host_ms = time_ms(
                lambda: gn_op.fused_group_norm_act(x, scale, bias, 32, 1e-6, act))
            row = {
                "shape": [batch, S, C], "act": act, "dtype": "bfloat16",
                "calls_per_step": calls, "max_abs_err": err, "rtol": rtol,
                "atol": atol, "ms": ms, "host_ms": host_ms,
                "plain_ms": time_ms(lambda: gn_op.group_norm_reference(
                    x, scale, bias, 32, 1e-6, act).bfloat16(), inner=5)[0],
                "library_ms": time_ms(library)[0],
                "bound_ms": b_ms, "bound_by": b_by,
            }
            rows.append(row)
            log(f"groupnorm bfloat16 B={batch} S={S} C={C} act={act} x{calls}/fwd: "
                f"max_abs_err {err:.3g} (tol rtol {rtol} atol {atol}) kernel_ms "
                f"{ms:.4f} (host {host_ms:.4f}) plain_ms {row['plain_ms']:.4f} library_ms "
                f"{row['library_ms']:.4f} bound_ms {b_ms:.4f} ({b_by}) "
                f"{'ok' if ok else 'MISMATCH'}")
            if not ok:
                fail(f"GroupNorm kernel disagrees with its plain version at "
                     f"{row['shape']} act={act}")
        return rows

    attn_rows = attention_fwd_rows(BATCH, (torch.bfloat16, torch.float32))
    gn_rows = group_norm_fwd_rows(BATCH)

    # ---- phase 3: full-width fp32 UNet and a short sample, card vs CPU ----
    log(f"phase 3 at {time.perf_counter() - t_start:.1f} s")
    net32 = unet_from_config(3, FLAGSHIP, dtype=torch.float32, device=dev)
    net32.load_state_dict(weights)
    with torch.no_grad():
        card_out = net32(x_small.to(dev), tau_small.to(dev)).cpu()
    scale_out = float(ref_out.abs().max())
    fwd_err = float((card_out - ref_out).abs().max())
    log(f"flagship UNet fp32 forward B=2, card (kernels) vs CPU (plain): "
        f"max_abs_err {fwd_err:.3g} of output scale {scale_out:.3g} "
        f"(tol {FORWARD_TOL} of scale)")
    if not (math.isfinite(fwd_err) and fwd_err <= FORWARD_TOL * scale_out):
        fail("fp32 UNet forward on the card disagrees with the CPU")

    x_init = torch.from_numpy(rng.standard_normal((2, 3, 32, 32)).astype(np.float32))
    samples = {}
    for name, net, d in (("cpu", cpu_net, "cpu"), ("card", net32, dev)):
        sampler = DDPMSampler(
            ddpm=UNetDDPM(sched, net, device=d), scheduler=sched, n_steps=10,
            obj_size=(3, 32, 32), batch_size=2, step_type="ddim", device=d)
        samples[name] = sampler.batch_sample(x_init=x_init)["x"].cpu()
    s_scale = float(samples["cpu"].abs().max())
    s_err = float((samples["card"] - samples["cpu"]).abs().max())
    log(f"10-step fp32 DDIM sample B=2, card vs CPU: max_abs_err {s_err:.3g} "
        f"of sample scale {s_scale:.3g} (tol {FORWARD_TOL} of scale)")
    if not (math.isfinite(s_err) and s_err <= FORWARD_TOL * s_scale):
        fail("fp32 DDIM sample on the card disagrees with the CPU")
    del net32, cpu_net

    # ---- phase 4: the main path ----
    log(f"phase 4 at {time.perf_counter() - t_start:.1f} s")
    net = unet_from_config(3, FLAGSHIP, dtype=torch.bfloat16, device=dev)
    net.load_state_dict(weights)
    ddpm = UNetDDPM(sched, net, parametrization="eps", device=dev)

    def sampler_of(n_steps):
        return DDPMSampler(
            ddpm=ddpm, scheduler=sched, n_steps=n_steps,
            obj_size=(3, 32, 32), batch_size=BATCH, n_samples=BATCH,
            step_type="ddpm", precision="half", device=dev)

    sampler_of(2).batch_sample(torch.Generator(device=dev).manual_seed(1))
    torch.cuda.synchronize()
    sampler = sampler_of(N_STEPS)
    gen = torch.Generator(device=dev).manual_seed(0)
    attn_op.fused_spatial_attention.launches = 0
    gn_op.fused_group_norm_act.launches = 0
    t0 = time.perf_counter()
    x = sampler.batch_sample(gen)["x"]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    attn_launches = attn_op.fused_spatial_attention.launches
    gn_launches = gn_op.fused_group_norm_act.launches
    ms_step = wall / N_STEPS * 1e3
    log(f"main path: DDPM {N_STEPS} steps, batch {BATCH}, bf16 flagship: "
        f"{wall:.3f} s, {ms_step:.3f} ms/step, {BATCH / wall:.3f} samples/s; "
        f"launches attention {attn_launches} ({attn_launches / N_STEPS:g}/step), "
        f"GroupNorm {gn_launches} ({gn_launches / N_STEPS:g}/step); output "
        f"{tuple(x.shape)} {x.dtype} mean {float(x.mean()):.4g} std "
        f"{float(x.std()):.4g}")
    if tuple(x.shape) != (BATCH, 3, 32, 32) or not bool(torch.isfinite(x).all()):
        fail(f"main-path output not finite of shape (64, 3, 32, 32): {tuple(x.shape)}")
    if attn_launches != 8 * N_STEPS or gn_launches != 69 * N_STEPS:
        fail(f"launch counts {attn_launches}, {gn_launches} != "
             f"{8 * N_STEPS}, {69 * N_STEPS}")
    # the card's busy time for one model evaluation of a step (the UNet and
    # the prediction algebra), timed with the host's enqueue hidden: the
    # rest of a step's wall time the card waits on the host
    x_in = torch.randn(BATCH, 3, 32, 32, generator=gen, device=dev).bfloat16()
    lt_top = sampler._grid()[-1]
    with torch.inference_mode():
        eval_ms, eval_host_ms = time_ms(
            lambda: ddpm.get_predictions(x_in, lt_top), reps=5, inner=1)
    log(f"main path: one model evaluation keeps the card busy {eval_ms:.3f} "
        f"ms and takes the host {eval_host_ms:.3f} ms to enqueue; the card "
        f"is idle {1.0 - eval_ms / ms_step:.1%} of a {ms_step:.3f} ms step")

    profile_steps(lambda: sampler_of(PROFILE_STEPS).batch_sample(gen),
                  PROFILE_STEPS)

    # ---- phase 5: backward kernels (and forward at the training batch) ----
    log(f"phase 5 at {time.perf_counter() - t_start:.1f} s")
    attn_train_rows = attention_fwd_rows(TRAIN_BATCH, (torch.bfloat16,))
    gn_train_rows = group_norm_fwd_rows(TRAIN_BATCH)

    def grad_ms(out, inputs, cot):
        return time_ms(lambda: torch.autograd.grad(out, inputs, cot,
                                                   retain_graph=True))[0]

    attn_bwd_rows = []
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        for (T, C, heads), calls in sorted(attn_calls.items(), reverse=True):
            B, hd = TRAIN_BATCH, C // heads
            qkv = torch.randn(B, T, 3 * C, generator=g, device=dev).to(dtype)
            q, k, v = qkv.split(C, dim=-1)
            do = torch.randn(B, T, C, generator=g, device=dev).to(dtype)
            scale = 1.0 / math.sqrt(hd)
            _, lse = attn_op.attention_with_lse(q, k, v, heads, scale)
            got = attn_op.attention_bwd(q, k, v, lse, do, heads, scale)
            want = attn_op.attention_bwd_reference(q, k, v, lse, do, heads, scale)
            torch.cuda.synchronize()
            rtol, atol = BWD_TOL[dname]
            checks = [compare_to_scale(a_, b_, rtol, atol)
                      for a_, b_ in zip(got, want)]
            err, ok = max(c[0] for c in checks), all(c[1] for c in checks)
            esz = qkv.element_size()
            b_ms, b_by = bound(7 * B * T * C * esz + B * heads * T * 4,
                               10 * B * T * T * C, dname)
            ms, host_ms = time_ms(lambda: attn_op.attention_bwd(
                q, k, v, lse, do, heads, scale))
            qh, kh, vh = (t.reshape(B, T, heads, hd).transpose(1, 2).detach()
                          .clone().requires_grad_() for t in (q, k, v))
            lib_out = F.scaled_dot_product_attention(qh, kh, vh, scale=scale)
            row = {
                "shape": [B, T, C], "heads": heads, "dtype": dname,
                "calls_per_step": calls if dtype == torch.bfloat16 else 0,
                "max_abs_err": err, "rtol": rtol, "atol_of_scale": atol,
                "ms": ms, "host_ms": host_ms,
                "plain_ms": time_ms(lambda: attn_op.attention_bwd_reference(
                    q, k, v, lse, do, heads, scale), inner=3)[0],
                "library_ms": grad_ms(lib_out, (qh, kh, vh), do.reshape(
                    B, T, heads, hd).transpose(1, 2)),
                "bound_ms": b_ms, "bound_by": b_by,
            }
            attn_bwd_rows.append(row)
            log(f"attention backward {dname} B={B} T={T} C={C} heads={heads}: "
                f"max_abs_err {err:.3g} (tol rtol {rtol} atol {atol} of scale) "
                f"kernel_ms {ms:.4f} (host {host_ms:.4f}) plain_ms "
                f"{row['plain_ms']:.4f} library_ms {row['library_ms']:.4f} "
                f"bound_ms {b_ms:.4f} ({b_by}) {'ok' if ok else 'MISMATCH'}")
            if not ok:
                fail(f"attention backward kernels disagree with their plain "
                     f"version at {row['shape']} {dname}")
            del lib_out, qh, kh, vh

    gn_bwd_rows = []
    for (S, C, act), calls in sorted(gn_calls.items(), reverse=True):
        B = TRAIN_BATCH
        x = torch.randn(B, S, C, generator=g, device=dev).bfloat16()
        dy = torch.randn(B, S, C, generator=g, device=dev).bfloat16()
        scale = 1.0 + 0.2 * torch.randn(C, generator=g, device=dev)
        bias = 0.1 * torch.randn(C, generator=g, device=dev)
        got = gn_op.group_norm_bwd(x, scale, bias, dy, 32, 1e-6, act)
        want = gn_op.group_norm_bwd_reference(x, scale, bias, dy, 32, 1e-6, act)
        torch.cuda.synchronize()
        rtol, atol = BWD_TOL["bfloat16"]
        checks = [compare_to_scale(got[0], want[0], rtol, atol)] + [
            compare_to_scale(a_, b_, *PARAM_GRAD_TOL)
            for a_, b_ in zip(got[1:], want[1:])]
        err, ok = max(c[0] for c in checks), all(c[1] for c in checks)
        side = int(round(math.sqrt(S)))
        x4 = (x.view(B, side, side, C).permute(0, 3, 1, 2).detach().clone()
              .requires_grad_())  # channels_last
        sc_b = scale.bfloat16().requires_grad_()
        bi_b = bias.bfloat16().requires_grad_()
        lib_out = F.group_norm(x4, 32, sc_b, bi_b, 1e-6)
        if act == "silu":
            lib_out = F.silu(lib_out)
        b_ms, b_by = bound(3 * B * S * C * 2 + 4 * C * 4,
                           GN_BWD_OPS[act] * B * S * C, "float32")
        ms, host_ms = time_ms(lambda: gn_op.group_norm_bwd(
            x, scale, bias, dy, 32, 1e-6, act))
        row = {
            "shape": [B, S, C], "act": act, "dtype": "bfloat16",
            "calls_per_step": calls, "max_abs_err": err, "rtol": rtol,
            "atol_of_scale": atol, "ms": ms, "host_ms": host_ms,
            "plain_ms": time_ms(lambda: gn_op.group_norm_bwd_reference(
                x, scale, bias, dy, 32, 1e-6, act), inner=3)[0],
            "library_ms": grad_ms(lib_out, (x4, sc_b, bi_b), dy.view(
                B, side, side, C).permute(0, 3, 1, 2)),
            "bound_ms": b_ms, "bound_by": b_by,
        }
        gn_bwd_rows.append(row)
        log(f"groupnorm backward bfloat16 B={B} S={S} C={C} act={act} "
            f"x{calls}/step: max_abs_err {err:.3g} (dx tol rtol {rtol} atol "
            f"{atol} of scale; dscale/dbias {PARAM_GRAD_TOL}) kernel_ms "
            f"{ms:.4f} (host {host_ms:.4f}) plain_ms {row['plain_ms']:.4f} "
            f"library_ms {row['library_ms']:.4f} bound_ms {b_ms:.4f} ({b_by}) "
            f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"GroupNorm backward kernel disagrees with its plain version "
                 f"at {row['shape']} act={act}")
        del lib_out, x4
    torch.cuda.empty_cache()

    # ---- phase 6: the full-width fp32 train step, card vs CPU ----
    log(f"phase 6 at {time.perf_counter() - t_start:.1f} s")
    lr6 = 1e-4
    x6 = torch.from_numpy(rng.standard_normal((2, 3, 32, 32)).astype(np.float32))
    tau6 = torch.from_numpy(rng.uniform(0.0, 1.0, 2).astype(np.float32))
    eps6 = torch.from_numpy(rng.standard_normal((2, 3, 32, 32)).astype(np.float32))
    step6 = {}
    for name, d in (("cpu", torch.device("cpu")), ("card", dev)):
        net6 = unet_from_config(3, {**FLAGSHIP, "dropout": 0.0},
                                dtype=torch.float32, device=d)
        tr6 = DDPMTrainer(UNetDDPM(sched, net6, device=d), learning_rate=lr6,
                          warmup_steps=0, grad_clip=1e9, ema_decay=0.9999)
        st6 = tr6.init_state(weights)
        st6, m6, grads6 = train_step_with_grads(
            tr6, st6, x6.to(d), tau=tau6.to(d), eps=eps6.to(d))
        step6[name] = (float(m6["loss"]), grads6,
                       {k: v.cpu() for k, v in st6.params.items()},
                       float(m6["grad_norm"]))
        del net6, tr6, st6
    torch.cuda.empty_cache()
    cpu6, card6 = step6["cpu"], step6["card"]
    loss_err = abs(card6[0] - cpu6[0]) / abs(cpu6[0])
    top = max(float(v.abs().max()) for v in cpu6[1].values())
    worst_grad, worst_step, bad = 0.0, 0.0, []
    for k, g6 in cpu6[1].items():
        e = float((card6[1][k] - g6).abs().max())
        tol_k = TRAIN_TOL["grad"] * float(g6.abs().max()) + TRAIN_TOL["grad_floor"] * top
        worst_grad = max(worst_grad, e / tol_k)
        excess = ((card6[2][k] - cpu6[2][k]).abs()
                  - adam_first_step_bound(card6[1][k], g6, lr6) - 1e-7)
        worst_step = max(worst_step, float(excess.max()))
        if e > tol_k or float(excess.max()) > 0:
            bad.append(k)
    log(f"flagship fp32 train step B=2, card (kernels) vs CPU (plain): loss "
        f"{card6[0]:.6g} vs {cpu6[0]:.6g} (rel err {loss_err:.3g}, tol "
        f"{TRAIN_TOL['loss']}); grad_norm {card6[3]:.6g} vs {cpu6[3]:.6g}; "
        f"worst gradient error {worst_grad:.3g} of its tolerance (1e-3 of its "
        f"scale + 1e-5 of {top:.3g}); params after one Adam step (lr {lr6}) "
        f"within the bound the gradients allow, worst excess {worst_step:.3g}")
    if not (loss_err <= TRAIN_TOL["loss"]) or bad:
        fail(f"fp32 train step on the card disagrees with the CPU: {bad[:5]}")

    # ---- phase 7: the training main path ----
    log(f"phase 7 at {time.perf_counter() - t_start:.1f} s")
    net_t = unet_from_config(3, FLAGSHIP, dtype=torch.bfloat16, device=dev)
    ddpm_t = UNetDDPM(sched, net_t, parametrization="eps", device=dev)
    hyper = dict(learning_rate=1e-4, warmup_steps=10, total_iters=1000,
                 grad_clip=1.0, ema_decay=0.9999)
    trainer = DDPMTrainer(ddpm_t, **hyper)
    state = trainer.init_state(weights)  # fp32 masters from the fp32 weights
    x_train = torch.from_numpy(np.random.RandomState(2).standard_normal(
        (TRAIN_BATCH, 3, 32, 32)).astype(np.float32)).to(dev)
    for it in range(1, TRAIN_WARM + 1):
        state, _ = trainer.train_step(state, x_train, step_generator(0, it, dev))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gens = [step_generator(0, TRAIN_WARM + i + 1, dev) for i in range(TRAIN_STEPS)]
    counters = ((attn_op.fused_spatial_attention, "attention_fwd"),
                (attn_op.attention_bwd, "attention_bwd"),
                (gn_op.fused_group_norm_act, "group_norm_fwd"),
                (gn_op.group_norm_bwd, "group_norm_bwd"))
    for fn, _ in counters:
        fn.launches = 0
    losses, norms, host_s = [], [], 0.0
    t0 = time.perf_counter()
    for gen in gens:
        t1 = time.perf_counter()
        state, m = trainer.train_step(state, x_train, gen)
        host_s += time.perf_counter() - t1
        losses.append(m["loss"])
        norms.append(m["grad_norm"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    train_launches = {key: fn.launches for fn, key in counters}
    losses, norms = torch.stack(losses).cpu(), torch.stack(norms).cpu()
    train_ms = wall / TRAIN_STEPS * 1e3
    host_ms = host_s / TRAIN_STEPS * 1e3
    log(f"training main path: bf16 flagship, fp32 masters, batch {TRAIN_BATCH}, "
        f"dropout 0.2, {hyper}: {TRAIN_STEPS} steps in {wall:.3f} s, "
        f"{train_ms:.3f} ms/step, {TRAIN_BATCH / wall * TRAIN_STEPS:.3f} img/s; "
        f"host {host_ms:.3f} ms/step inside train_step (waits on the "
        f"launch queue included); "
        f"launches {train_launches} "
        f"({ {k: v / TRAIN_STEPS for k, v in train_launches.items()} } per step); "
        f"loss first {float(losses[0]):.5g} last {float(losses[-1]):.5g}, "
        f"grad_norm first {float(norms[0]):.5g} last {float(norms[-1]):.5g}; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if not (bool(torch.isfinite(losses).all()) and bool(torch.isfinite(norms).all())):
        fail("training main path: loss or grad_norm not finite")
    want_launches = {k: v * TRAIN_STEPS for k, v in TRAIN_LAUNCHES.items()}
    if train_launches != want_launches:
        fail(f"training launch counts {train_launches} != {want_launches}")
    # the card's busy time per step: the sum of its kernels' times in a
    # profiler trace (a step enqueues more kernels than the launch queue
    # holds, so the sleep-kernel timing of phase 4 cannot hide its enqueue)
    gen_b = step_generator(0, 10_000, dev)
    busy_ms = profile_steps(lambda: [trainer.train_step(state, x_train, gen_b)
                                     for _ in range(TRAIN_PROFILE_STEPS)],
                            TRAIN_PROFILE_STEPS, label="training profile")
    # the host's time inside train_step includes its waits on that full
    # queue, so it tracks the wall time whichever side is slower; the
    # verdict comes from the card's idle time instead
    idle_ms = train_ms - busy_ms
    log(f"training main path: the card is busy {busy_ms:.3f} ms of a "
        f"{train_ms:.3f} ms step and idle {idle_ms:.3f} ms "
        f"({idle_ms / train_ms:.1%}), so the "
        f"{'host' if idle_ms > 0.1 * train_ms else 'card'} bounds the step")

    # checkpoint: save, resume into a fresh trainer, one more step
    with tempfile.TemporaryDirectory() as ckpt_dir:
        trainer.checkpoint_dir = ckpt_dir
        t0 = time.perf_counter()
        trainer.save_checkpoint(state, state.step)
        save_s = time.perf_counter() - t0
        net_r = unet_from_config(3, FLAGSHIP, dtype=torch.bfloat16, device=dev)
        resumed = DDPMTrainer(UNetDDPM(sched, net_r, device=dev),
                              checkpoint_dir=ckpt_dir, **hyper)
        t0 = time.perf_counter()
        st_r = resumed.load_checkpoint(resumed.init_state(),
                                       resumed.latest_checkpoint_step())
        load_s = time.perf_counter() - t0
    same = st_r.step == state.step and all(
        torch.equal(getattr(st_r, key)[k], v)
        for key in ("params", "ema_params") for k, v in getattr(state, key).items())
    sa, sb = state.optimizer.state_dict()["state"], st_r.optimizer.state_dict()["state"]
    same = same and all(torch.equal(sa[i][f], sb[i][f]) for i in sa
                        for f in ("exp_avg", "exp_avg_sq", "step"))
    same = same and all(torch.equal(p, q_) for p, q_ in zip(
        net_t.parameters(), net_r.parameters()))
    st_r, m_r = resumed.train_step(st_r, x_train, step_generator(0, st_r.step + 1, dev))
    log(f"checkpoint: saved step {state.step} in {save_s:.2f} s, resumed in "
        f"{load_s:.2f} s, resumed state equal to the saved one: {same}; one more "
        f"step on the card: loss {float(m_r['loss']):.5g} grad_norm "
        f"{float(m_r['grad_norm']):.5g}")
    if not same or not math.isfinite(float(m_r["loss"])):
        fail("checkpoint resume did not restore the saved state")

    # ---- phase 8: the kernels line and the result ----
    log(f"phase 8 at {time.perf_counter() - t_start:.1f} s")
    def per_path(rows, launches, n_steps):
        main = [r for r in rows if r["calls_per_step"]]

        def per_step(key):
            return sum(r[key] * r["calls_per_step"] for r in main)

        bound_ms = per_step("bound_ms")
        by_bytes = sum(r["bound_ms"] * r["calls_per_step"] for r in main
                       if r["bound_by"] == "bytes")
        return {
            "launches": launches, "launches_per_step": launches / n_steps,
            "ms": per_step("ms"), "host_ms": per_step("host_ms"),
            "plain_ms": per_step("plain_ms"), "bound_ms": bound_ms,
            "bound_by": "bytes" if by_bytes >= bound_ms / 2 else "operations",
            "library_ms": per_step("library_ms"),
        }

    def entry(name, source, replaces, paths):
        """paths: (path, rows, launches, steps) for each main path that
        runs the kernel; the first gives the headline numbers."""
        per = {path: per_path(rows, launches, n) for path, rows, launches, n in paths}
        head = per[paths[0][0]]
        rows = [r for _, path_rows, _, _ in paths for r in path_rows]
        return {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(v["launches"] for v in per.values()),
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "per": f"main-path step of the {paths[0][0]} path: sum over the "
                   f"step's calls at their shapes of the per-call medians in "
                   f"'shapes'; 'paths' gives each path's",
            **{k: head[k] for k in ("ms", "host_ms", "plain_ms", "bound_ms",
                                    "bound_by", "library_ms")},
            "paths": per,
            "shapes": rows,
        }

    kernels = [
        entry("fused_spatial_attention", "pdm_tpu_torch/csrc/attention.cu",
              "pdm_tpu/ops/attention.py:75",
              [("sampling", attn_rows, attn_launches, N_STEPS),
               ("training", attn_train_rows, train_launches["attention_fwd"],
                TRAIN_STEPS)]),
        entry("attention_bwd", "pdm_tpu_torch/csrc/attention_bwd.cu",
              "pdm_tpu/ops/attention.py:123",
              [("training", attn_bwd_rows, train_launches["attention_bwd"],
                TRAIN_STEPS)]),
        entry("fused_group_norm_act", "pdm_tpu_torch/csrc/groupnorm.cu",
              "pdm_tpu/ops/groupnorm.py:99",
              [("sampling", gn_rows, gn_launches, N_STEPS),
               ("training", gn_train_rows, train_launches["group_norm_fwd"],
                TRAIN_STEPS)]),
        entry("group_norm_bwd", "pdm_tpu_torch/csrc/groupnorm_bwd.cu",
              "pdm_tpu/ops/groupnorm.py:112",
              [("training", gn_bwd_rows, train_launches["group_norm_bwd"],
                TRAIN_STEPS)]),
    ]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
