"""Fused multi-temperature Boltzmann sweep: the thermodynamic-sweep hot path.

Counterpart of ``pdm_tpu/ops/boltzmann_sweep.py``. The sweeps of
``stats/sweep.py`` evaluate the Boltzmann posterior of noised starts
``xt(T) = x0 + sqrt(T) eps`` at many temperatures, with ONE noise draw
shared across them. The energy then decomposes over one pair of Grams:

    h_ij(T) = C0_ij + sqrt(T) * D0_ij + T * esq_i
    C0_ij   = 0.5|x0_i|^2 - x0_i.y_j + 0.5|y_j|^2
    D0_ij   = x0_i.eps_i - eps_i.y_j
    esq_i   = 0.5|eps_i|^2
    logits  l_ij(T) = -h/T = -C0/T - D0/sqrt(T) - esq_i

and every temperature's online-softmax moments come from the same C0 and
D0 tiles: two Grams and an elementwise epilogue per temperature, the
(B x N x n_temps) logits never stored.

On CUDA tensors :func:`boltzmann_sweep` launches the hand-written kernels
of ``csrc/boltzmann_sweep.cu`` (they replace the TPU kernel
``_sweep_kernel``) in every precision mode: a partials kernel, where each
block owns one tile of starts (128 rows in fp32, 64 in the bf16 modes)
and one chunk of the dataset, and a merge kernel that joins the chunks'
partials with the exact shift-stabilized merge; :func:`plan_sweep` (a
pure function) gives a call's tile and chunks. On CPU tensors it runs
:func:`boltzmann_sweep_reference`, the plain version with the kernel's
decomposition and rounding points. Neither gives way to the other. Launch counter: ``boltzmann_sweep.launches`` (two
per call).

:func:`boltzmann_sweep_per_temp` is the independent oracle: one plain
moments pass per temperature at xt, as ``boltzmann_sweep_xla``. It calls
the moments op's plain version by name, so on the card it stays
independent of the moments kernel too.

The dataset is packed once (:func:`prepare_y`: transposed to (D, Np),
padded to the kernel's 128-column tiles, split to bf16 hi/lo for the
bf16 modes, with its half squared norms); callers that sweep one dataset
many times pass the pack instead of the raw array.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch
from torch import Tensor

from . import _build
from .boltzmann import BoltzmannMoments, boltzmann_moments_reference
from .precision import split, split_matmul, sweep_precision_mode

TILE_ROWS = 64  # queries per block (kTB in the source)
TALL_TILE_ROWS = 128  # queries per block of the fp32 kernels (kTBT in the sources)
TILE_COLS = 128  # dataset points per sub-tile (kTN in the source)
MODE_CODES = {"fp32": 0, "bf16_3x": 1, "bf16": 2}
# fp32 words of the plain version's (n_temps, B, chunk) logit temporaries
_EPILOGUE_WORDS = 1 << 25


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


class PreparedY(NamedTuple):
    """Kernel-ready dataset pack for one precision mode."""

    yt_hi: Tensor  # (D, Np) fp32 ("fp32") or bf16: y transposed, 0-padded
    yt_lo: Optional[Tensor]  # (D, Np) bf16, "bf16_3x" only
    ysq: Tensor  # (Np,) fp32: 0.5 |y_j|^2 (0 on padding)
    n: int  # true N
    d: int  # D
    mode: str


def prepare_y(y: Tensor, mxu_precision: Optional[str] = None) -> PreparedY:
    """Pad, transpose, split and norm a dataset (N, ...) once, on its
    device; reuse the pack across sweep calls of the same mode."""
    mode = sweep_precision_mode(mxu_precision)
    yf = y.reshape(y.shape[0], -1).to(torch.float32)
    n, d = yf.shape
    n_pad = round_up(n, TILE_COLS)
    yt = torch.zeros((d, n_pad), dtype=torch.float32, device=yf.device)
    yt[:, :n] = yf.T
    ysq = torch.zeros((n_pad,), dtype=torch.float32, device=yf.device)
    ysq[:n] = 0.5 * torch.sum(yf * yf, dim=1)
    hi, lo = split(yt, mode)
    return PreparedY(hi, lo, ysq, n, d, mode)


def pack(y, mode: str) -> PreparedY:
    """``y`` itself when it is a pack (of ``mode``), else its pack."""
    if isinstance(y, PreparedY):
        if y.mode != mode:
            raise ValueError(f"PreparedY was built for mxu_precision "
                             f"{y.mode!r}, not {mode!r}; call prepare_y(y, "
                             f"{mode!r})")
        return y
    return prepare_y(y, mode)


def _row_terms(xf: Tensor, ef: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """(0.5|x0|^2, x0.eps, 0.5|eps|^2) per row, fp32."""
    return (0.5 * torch.sum(xf * xf, dim=1), torch.sum(xf * ef, dim=1),
            0.5 * torch.sum(ef * ef, dim=1))


def _check_values(values: Optional[Tensor], n: int) -> Optional[Tensor]:
    if values is None:
        return None
    if values.shape != (n, 1):
        raise ValueError(f"the sweep's payload is (N, 1) = ({n}, 1): "
                         f"{tuple(values.shape)}")
    return values.to(torch.float32).reshape(n)


def boltzmann_sweep_reference(
    x0: Tensor,
    eps: Tensor,
    y,
    temps: Tensor,
    *,
    values: Optional[Tensor] = None,
    mxu_precision: Optional[str] = None,
) -> BoltzmannMoments:
    """Plain PyTorch version of the sweep kernel, with its decomposition
    and rounding points: C0, D0 and esq once (in the mode's split
    arithmetic: products of bf16 values summed in fp32), then the
    per-temperature online-softmax update over dataset chunks. Returns
    (n_temps, B) fields; ``mean`` (n_temps, B, 1) when ``values`` (N, 1)
    is given."""
    mode = sweep_precision_mode(mxu_precision)
    prep = pack(y, mode)
    n = prep.n
    B = x0.shape[0]
    xf = x0.reshape(B, -1).to(torch.float32)
    ef = eps.reshape(B, -1).to(torch.float32)
    v = _check_values(values, n)
    temps = torch.as_tensor(temps, dtype=torch.float32, device=xf.device)
    nt = temps.shape[0]
    xsq, xe, esq = _row_terms(xf, ef)
    yt_hi = prep.yt_hi[:, :n]
    yt_lo = None if prep.yt_lo is None else prep.yt_lo[:, :n]
    x_hi, x_lo = split(xf, mode)
    e_hi, e_lo = split(ef, mode)
    c0 = (xsq[:, None] - split_matmul(x_hi, x_lo, yt_hi, yt_lo)) + prep.ysq[None, :n]
    d0 = xe[:, None] - split_matmul(e_hi, e_lo, yt_hi, yt_lo)
    invt = (1.0 / temps)[:, None, None]
    irt = (1.0 / torch.sqrt(temps))[:, None, None]

    m = torch.full((nt, B), float("-inf"), dtype=torch.float32, device=xf.device)
    s0 = torch.zeros_like(m)
    s1 = torch.zeros_like(m)
    s2 = torch.zeros_like(m)
    sy = torch.zeros_like(m)
    chunk = max(TILE_COLS, _EPILOGUE_WORDS // max(nt * B, 1))
    for lo in range(0, n, chunk):
        cc, dc = c0[None, :, lo:lo + chunk], d0[None, :, lo:lo + chunk]
        lg = -(invt * cc + irt * dc) - esq[None, :, None]  # (nt, B, chunk)
        m_new = torch.maximum(m, torch.max(lg, dim=-1).values)
        finite = m > float("-inf")
        c = torch.where(finite, torch.exp(m - m_new), 0.0)
        delta = torch.where(finite, m_new - m, 0.0)
        p = torch.exp(lg - m_new[..., None])
        g_hat = m_new[..., None] - lg
        pg = p * g_hat
        s0, s1, s2 = (
            s0 * c + torch.sum(p, dim=-1),
            (s1 + delta * s0) * c + torch.sum(pg, dim=-1),
            (s2 + (2.0 * delta) * s1 + (delta * delta) * s0) * c
            + torch.sum(pg * g_hat, dim=-1),
        )
        if v is not None:
            sy = sy * c + torch.sum(p * v[lo:lo + chunk], dim=-1)
        m = m_new
    return BoltzmannMoments(
        log_z=m + torch.log(s0), shift=m, e1_hat=s1 / s0, e2_hat=s2 / s0,
        mean=None if v is None else (sy / s0)[..., None])


def boltzmann_sweep_per_temp(
    x0: Tensor,
    eps: Tensor,
    y: Tensor,
    temps: Tensor,
    *,
    values: Optional[Tensor] = None,
) -> BoltzmannMoments:
    """The per-temperature oracle (``boltzmann_sweep_xla``): one plain fp32
    moments pass per T at xt = x0 + sqrt(T) eps, stacked to (n_temps, B)."""
    temps = torch.as_tensor(temps, dtype=torch.float32, device=x0.device)
    outs = []
    for t in temps:
        xt = x0 + torch.sqrt(t) * eps
        outs.append(boltzmann_moments_reference(
            xt, y, inv_temp=1.0 / t, values=values, mxu_precision="fp32"))
    return BoltzmannMoments(*(
        None if f[0] is None else torch.stack(f) for f in zip(*outs)))


@functools.lru_cache(maxsize=None)
def _resident_blocks(kernel: str, device_index: int, mode_code: int,
                     variant: int) -> int:
    """Blocks of a partials kernel (``kernel``: "sweep" or "moments"; the
    variant: with values or the payload's form) the card holds at once."""
    per_sm = ctypes.c_int(0)
    name = f"pdm_boltzmann_{kernel}_blocks_per_sm"
    fn = _build.entry(name, _SLOTS_ARGS)
    with torch.cuda.device(device_index):
        _build.check(fn(mode_code, variant, ctypes.byref(per_sm)), name)
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    return max(1, per_sm.value) * sms


@functools.lru_cache(maxsize=None)
def split_chunks(slots: int, row_tiles: int, n_tiles: int) -> Tuple[int, int]:
    """(n_chunks, tiles per chunk): a dataset of ``n_tiles`` column tiles
    cut into chunks for ``row_tiles`` x n_chunks blocks (or clusters), of
    which the card holds ``slots`` at once. The count minimizes waves per
    chunk, each chunk costing 1% more (its partials and its share of the
    merge): at the main shapes one wave of as many chunks as fit; where the
    row tiles fill the card badly, as 16 row tiles on 15 slots, more waves
    of smaller chunks. Chunks are whole tiles; none is empty."""
    slots, best, best_cost = max(1, slots), 1, float("inf")
    for n in range(1, min(n_tiles, 2 * slots) + 1):
        waves = -(-row_tiles * n // slots)
        cost = waves / n * (1.0 + 0.01 * n)
        if cost < best_cost:
            best, best_cost = n, cost
    per_chunk = -(-n_tiles // best)
    return -(-n_tiles // per_chunk), per_chunk


class SweepPlan(NamedTuple):
    """How one sweep call runs: query rows per block and the split."""

    tile_rows: int
    n_chunks: int
    per_chunk: int  # 128-column sub-tiles per chunk


def plan_sweep(mode: str, n_rows: int, n_pad: int, slots: int) -> SweepPlan:
    """The launch plan of a sweep over ``n_rows`` starts and a dataset
    padded to ``n_pad`` columns, where the card holds ``slots`` blocks of
    the mode's partials kernel."""
    rows = sweep_tile_rows(mode)
    return SweepPlan(rows, *split_chunks(slots, -(-n_rows // rows), n_pad // TILE_COLS))


def sweep_tile_rows(mode: str) -> int:
    """Queries per block of the sweep's partials kernel in ``mode``: the
    fp32 kernel takes 128-row tiles, the bf16 modes' 64-row ones."""
    return TALL_TILE_ROWS if mode == "fp32" else TILE_ROWS


def check_pack(prep: PreparedY, dev: torch.device) -> None:
    """The kernel reads the pack through raw pointers: its layout must be
    prepare_y's."""
    n_pad = prep.yt_hi.shape[1] if prep.yt_hi.ndim == 2 else -1
    want = torch.float32 if prep.mode == "fp32" else torch.bfloat16
    parts = [("yt_hi", prep.yt_hi, want, (prep.d, n_pad)),
             ("ysq", prep.ysq, torch.float32, (n_pad,))]
    if (prep.yt_lo is not None) != (prep.mode == "bf16_3x"):
        raise ValueError(f"a {prep.mode!r} pack has yt_lo only in bf16_3x")
    if prep.yt_lo is not None:
        parts.append(("yt_lo", prep.yt_lo, torch.bfloat16, (prep.d, n_pad)))
    if n_pad % TILE_COLS or not 0 < prep.n <= n_pad:
        raise ValueError(f"the pack's N = {prep.n} must fit its padded "
                         f"{n_pad}, a multiple of {TILE_COLS}")
    for name, t, dtype, shape in parts:
        if (t.dtype != dtype or tuple(t.shape) != shape or t.device != dev
                or not t.is_contiguous()):
            raise ValueError(f"PreparedY.{name} must be contiguous {dtype} "
                             f"{shape} on {dev}: {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")


def _sweep_cuda(xf: Tensor, ef: Tensor, prep: PreparedY, temps: Tensor,
                v: Optional[Tensor]) -> BoltzmannMoments:
    dev = xf.device
    B, D = xf.shape
    if prep.d != D or ef.shape != xf.shape:
        raise ValueError(f"x0 {tuple(xf.shape)} and eps {tuple(ef.shape)} "
                         f"must be (B, D) with the dataset's D = {prep.d}")
    check_pack(prep, dev)
    for name, t in (("eps", ef), ("temps", temps)):
        if t.device != dev:
            raise ValueError(f"{name} must be on {dev}: {t.device}")
    if v is not None and v.device != dev:
        raise ValueError(f"values must be on {dev}: {v.device}")
    n_pad = prep.yt_hi.shape[1]
    plan = plan_sweep(prep.mode, B, n_pad, _resident_blocks(
        "sweep", dev.index or 0, MODE_CODES[prep.mode], int(v is not None)))
    n_chunks, per_chunk = plan.n_chunks, plan.per_chunk
    b_pad = round_up(B, plan.tile_rows)
    nt = temps.shape[0]
    xt = torch.zeros((D, b_pad), dtype=torch.float32, device=dev)
    et = torch.zeros_like(xt)
    xt[:, :B] = xf.T
    et[:, :B] = ef.T
    x_hi, x_lo = split(xt, prep.mode)
    e_hi, e_lo = split(et, prep.mode)
    row = torch.zeros((3, b_pad), dtype=torch.float32, device=dev)
    row[0, :B], row[1, :B], row[2, :B] = _row_terms(xf, ef)
    invt = (1.0 / temps).contiguous()
    irt = (1.0 / torch.sqrt(temps)).contiguous()
    vp = None
    if v is not None:
        vp = torch.zeros((n_pad,), dtype=torch.float32, device=dev)
        vp[:prep.n] = v
    n_q = 5 if v is not None else 4
    partials = torch.empty((n_chunks, n_q, nt, b_pad), dtype=torch.float32,
                           device=dev)
    out = torch.empty((n_q, nt, B), dtype=torch.float32, device=dev)

    def ptr(t: Optional[Tensor]) -> Optional[int]:
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        fn = _build.entry("pdm_boltzmann_sweep_partials", _PARTIALS_ARGS)
        err = fn(ptr(x_hi), ptr(x_lo), ptr(e_hi), ptr(e_lo), ptr(prep.yt_hi),
                 ptr(prep.yt_lo), ptr(prep.ysq), ptr(row[0]), ptr(row[1]),
                 ptr(row[2]), ptr(vp), ptr(invt), ptr(irt),
                 ptr(partials), b_pad, D, n_pad, prep.n, nt, n_chunks,
                 per_chunk, MODE_CODES[prep.mode], stream)
        _build.check(err, "pdm_boltzmann_sweep_partials")
        boltzmann_sweep.launches += 1
        fn = _build.entry("pdm_boltzmann_sweep_merge", _MERGE_ARGS)
        err = fn(ptr(partials), ptr(out), B, b_pad, nt, n_chunks, n_q, stream)
        _build.check(err, "pdm_boltzmann_sweep_merge")
        boltzmann_sweep.launches += 1
    return BoltzmannMoments(
        log_z=out[0], shift=out[1], e1_hat=out[2], e2_hat=out[3],
        mean=out[4][..., None] if v is not None else None)


def boltzmann_sweep(
    x0: Tensor,
    eps: Tensor,
    y,
    temps: Tensor,
    *,
    values: Optional[Tensor] = None,
    mxu_precision: Optional[str] = None,
) -> BoltzmannMoments:
    """Moments of the posterior at xt(T) = x0 + sqrt(T) eps for every T.

    ``x0``, ``eps`` (B, ...); ``y`` a raw dataset (N, ...) or its
    :class:`PreparedY` for the same mode; ``temps`` (n_temps,);
    ``values`` (N, 1), the posterior mean of which comes back as ``mean``
    (n_temps, B, 1). ``mxu_precision``: see ``ops/precision.py``. The
    kernels on CUDA tensors, the plain version on CPU tensors. Returns
    BoltzmannMoments with (n_temps, B) fields.
    """
    mode = sweep_precision_mode(mxu_precision)
    if x0.device.type == "cpu":
        return boltzmann_sweep_reference(x0, eps, y, temps, values=values,
                                         mxu_precision=mode)
    if x0.device.type != "cuda":
        raise ValueError(f"unsupported device {x0.device}")
    prep = pack(y, mode)
    B = x0.shape[0]
    temps = torch.as_tensor(temps, dtype=torch.float32, device=x0.device)
    if temps.ndim != 1 or temps.shape[0] == 0:
        raise ValueError(f"temps must be (n_temps,): {tuple(temps.shape)}")
    return _sweep_cuda(x0.reshape(B, -1).to(torch.float32),
                       eps.reshape(B, -1).to(torch.float32), prep, temps,
                       _check_values(values, prep.n))


# kernel launches since the last reset (set to 0 to reset)
boltzmann_sweep.launches = 0

_P, _I = ctypes.c_void_p, ctypes.c_int
_PARTIALS_ARGS = [_P] * 14 + [_I] * 8 + [_P]
_MERGE_ARGS = [_P, _P, _I, _I, _I, _I, _I, _P]
_SLOTS_ARGS = [_I, _I, ctypes.POINTER(ctypes.c_int)]
