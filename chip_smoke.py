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
5. One JSON line {"kernels": [...]}, then the last line
   {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
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
        sleep_ms, dev, host = 10.0, [], []
        while len(dev) < reps:
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


def seeded_state_dict(net, seed: int = 0, std: float = 0.02):
    """Random weights from a seed, every parameter N(0, std^2), in state
    dict order (as bench.py fills the JAX flagship)."""
    import torch

    rng = np.random.RandomState(seed)
    return {k: torch.from_numpy(
                (rng.standard_normal(tuple(v.shape)) * std).astype(np.float32))
            for k, v in net.state_dict().items()}


def profile_steps(run, n_steps: int) -> None:
    """Print the card's kernel time per main-path step, by kernel and by
    kind, from a torch.profiler trace of `run` (n_steps sampler steps)."""
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
        if e.device_type == DeviceType.CUDA:
            ms, n = per_kernel.get(e.name, (0.0, 0))
            per_kernel[e.name] = (ms + e.device_time_total / 1e3, n + 1)
    kinds = (("attention kernel", ("attention_fwd",)),
             ("GroupNorm kernel", ("group_norm_fwd",)),
             ("convolution", ("conv", "fprop", "nhwc", "nchw")),
             ("matmul", ("gemm", "cutlass", "cublas", "nvjet")))
    by_kind = {name: [0.0, 0] for name, _ in kinds}
    by_kind["other"] = [0.0, 0]
    for kname, (ms, n) in per_kernel.items():
        kind = next((name for name, keys in kinds
                     if any(key in kname.lower() for key in keys)), "other")
        by_kind[kind][0] += ms
        by_kind[kind][1] += n
    busy = sum(ms for ms, _ in per_kernel.values())
    log(f"profile: {n_steps} steps, {wall_ms / n_steps:.3f} ms/step wall "
        f"under the profiler, card busy {busy / n_steps:.3f} ms/step "
        f"({busy / wall_ms:.1%}), "
        f"{sum(n for _, n in per_kernel.values()) / n_steps:g} launches/step")
    for kind, (ms, n) in sorted(by_kind.items(), key=lambda kv: -kv[1][0]):
        log(f"profile: {kind}: {ms / n_steps:.4f} ms/step, {n / n_steps:g} "
            f"launches/step")
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:15]
    for kname, (ms, n) in top:
        log(f"profile kernel: {ms / n_steps:.4f} ms/step x{n / n_steps:g} "
            f"{kname[:110]}")


def main() -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from pdm_tpu_torch.diffusion.sampling import DDPMSampler
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
    g = torch.Generator(device=dev).manual_seed(0)
    attn_rows = []
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        for (T, C, heads), calls in sorted(attn_calls.items(), reverse=True):
            qkv = torch.randn(BATCH, T, 3 * C, generator=g, device=dev).to(dtype)
            q, k, v = qkv.split(C, dim=-1)  # the UNet's layout: rows 3C apart
            scale = 1.0 / math.sqrt(C // heads)
            out, lse = attn_op.attention_with_lse(q, k, v, heads, scale)
            ref, ref_lse = attn_op._reference_with_lse(q, k, v, heads, scale)
            torch.cuda.synchronize()
            err, ok, rtol, atol = compare(out, ref, dname)
            lse_err = float((lse - ref_lse).abs().max())
            ok = ok and lse_err <= 1e-4 * (1.0 + float(ref_lse.abs().max()))
            hd = C // heads
            qh, kh, vh = (t.view(BATCH, T, heads, hd).transpose(1, 2)
                          for t in (q, k, v))
            esz = qkv.element_size()
            b_ms, b_by = bound(4 * BATCH * T * C * esz + BATCH * heads * T * 4,
                               4 * BATCH * T * T * C, dname)
            ms, host_ms = time_ms(
                lambda: attn_op.attention_with_lse(q, k, v, heads, scale))
            row = {
                "shape": [BATCH, T, C], "heads": heads, "dtype": dname,
                "calls_per_step": calls if dtype == torch.bfloat16 else 0,
                "max_abs_err": err, "lse_max_abs_err": lse_err,
                "rtol": rtol, "atol": atol, "ms": ms, "host_ms": host_ms,
                "plain_ms": time_ms(lambda: attn_op._reference_with_lse(
                    q, k, v, heads, scale), inner=5)[0],
                "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                    qh, kh, vh, scale=scale))[0],
                "bound_ms": b_ms, "bound_by": b_by,
            }
            attn_rows.append(row)
            log(f"attention {dname} B={BATCH} T={T} C={C} heads={heads}: "
                f"max_abs_err {err:.3g} (lse {lse_err:.3g}; tol rtol {rtol} "
                f"atol {atol}) kernel_ms {ms:.4f} (host {host_ms:.4f}) plain_ms "
                f"{row['plain_ms']:.4f} library_ms {row['library_ms']:.4f} "
                f"bound_ms {b_ms:.4f} ({b_by}) {'ok' if ok else 'MISMATCH'}")
            if not ok:
                fail(f"attention kernel disagrees with its plain version at "
                     f"{row['shape']} {dname}")

    gn_rows = []
    for (S, C, act), calls in sorted(gn_calls.items(), reverse=True):
        x = torch.randn(BATCH, S, C, generator=g, device=dev).bfloat16()
        scale = 1.0 + 0.2 * torch.randn(C, generator=g, device=dev)
        bias = 0.1 * torch.randn(C, generator=g, device=dev)
        y = gn_op.fused_group_norm_act(x, scale, bias, 32, 1e-6, act)
        ref = gn_op.group_norm_reference(x, scale, bias, 32, 1e-6, act).bfloat16()
        torch.cuda.synchronize()
        err, ok, rtol, atol = compare(y, ref, "bfloat16")
        side = int(round(math.sqrt(S)))
        x4 = x.view(BATCH, side, side, C).permute(0, 3, 1, 2)  # channels_last
        sc_b, bi_b = scale.bfloat16(), bias.bfloat16()

        def library(x4=x4, sc_b=sc_b, bi_b=bi_b, act=act):
            z = F.group_norm(x4, 32, sc_b, bi_b, 1e-6)
            return F.silu(z) if act == "silu" else z

        b_ms, b_by = bound(2 * BATCH * S * C * 2 + 2 * C * 4,
                           (12 if act == "silu" else 8) * BATCH * S * C,
                           "float32")
        ms, host_ms = time_ms(
            lambda: gn_op.fused_group_norm_act(x, scale, bias, 32, 1e-6, act))
        row = {
            "shape": [BATCH, S, C], "act": act, "dtype": "bfloat16",
            "calls_per_step": calls, "max_abs_err": err, "rtol": rtol,
            "atol": atol, "ms": ms, "host_ms": host_ms,
            "plain_ms": time_ms(lambda: gn_op.group_norm_reference(
                x, scale, bias, 32, 1e-6, act).bfloat16(), inner=5)[0],
            "library_ms": time_ms(library)[0],
            "bound_ms": b_ms, "bound_by": b_by,
        }
        gn_rows.append(row)
        log(f"groupnorm bfloat16 B={BATCH} S={S} C={C} act={act} x{calls}/fwd: "
            f"max_abs_err {err:.3g} (tol rtol {rtol} atol {atol}) kernel_ms "
            f"{ms:.4f} (host {host_ms:.4f}) plain_ms {row['plain_ms']:.4f} library_ms "
            f"{row['library_ms']:.4f} bound_ms {b_ms:.4f} ({b_by}) "
            f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"GroupNorm kernel disagrees with its plain version at "
                 f"{row['shape']} act={act}")

    # ---- phase 3: full-width fp32 UNet and a short sample, card vs CPU ----
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

    # ---- phase 5: the kernels line and the result ----
    def entry(name, source, replaces, rows, launches):
        main = [r for r in rows if r["calls_per_step"]]

        def per_step(key):
            return sum(r[key] * r["calls_per_step"] for r in main)

        bound_ms = per_step("bound_ms")
        by_bytes = sum(r["bound_ms"] * r["calls_per_step"] for r in main
                       if r["bound_by"] == "bytes")
        return {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "launches_per_step": launches / N_STEPS,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "per": "main-path step: sum over the step's launches at their "
                   "shapes of the per-launch medians in 'shapes'",
            "ms": per_step("ms"), "host_ms": per_step("host_ms"),
            "plain_ms": per_step("plain_ms"),
            "bound_ms": bound_ms,
            "bound_by": "bytes" if by_bytes >= bound_ms / 2 else "operations",
            "library_ms": per_step("library_ms"),
            "shapes": rows,
        }

    kernels = [
        entry("fused_spatial_attention", "pdm_tpu_torch/csrc/attention.cu",
              "pdm_tpu/ops/attention.py:75", attn_rows, attn_launches),
        entry("fused_group_norm_act", "pdm_tpu_torch/csrc/groupnorm.cu",
              "pdm_tpu/ops/groupnorm.py:99", gn_rows, gn_launches),
    ]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
