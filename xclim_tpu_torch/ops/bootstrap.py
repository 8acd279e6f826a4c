"""Year-replacement quantiles for the Zhang-2005 bootstrap.

The bootstrap recomputes each doy-window quantile with one in-base year's
samples replaced by another's, for every ordered year pair; xclim re-sorts
the full sample set per pair (xclim:core/bootstrapping.py:195-201). Here the
samples are ranked once into top-k / bottom-k candidate tables
(:func:`topk_rank_tables`), and each pair's order statistics are recovered
from the table with year b's entries removed, merged with the added year's
samples (:func:`merge_rank_replaced_year_quantile`): no per-pair sort.

On a CUDA tensor :func:`merge_rank_replaced_year_quantile` launches the
hand-written kernel ``csrc/bootstrap.cu`` (a thread per (doy, cell) lane:
its table minus year b compacted once, then every replacement's samples
sorted in registers and both order statistics read by the merge path) and
raises if the launch fails. It takes the in-base sample tensor as
``samples=`` and reads the other years in place; the positional form
(``A_b``, ``A_o``) is the twin's alone. Where the table
(more than :data:`MAX_SHARED_K` slots) or the window (more than
:data:`MAX_REGISTER_W` samples) outgrows the shared-memory instance, the
same kernel keeps them in global scratch; the two instances are counted
apart in ``shared_launches`` and ``global_launches``
(:func:`table_in_shared`). On a CPU tensor it runs the plain PyTorch twin
:func:`merge_rank_replaced_year_quantile_plain`, which the kernel equals
bit for bit. ``launches`` and ``twin_calls`` count the calls each path
served.

Counterpart of the reference's ``xclim_tpu/ops/bootstrap.py``. Its public
bootstrap calls ``topk_replaced_year_quantile`` (a top_k of the table and
the added samples per pair); ``merge_rank_replaced_year_quantile`` gives the
same answer bit for bit (tests/test_ops.py), so the port serves both with
the merge form. NaNs (missing samples at series edges, absent leap days)
are excluded from every count.
"""

from __future__ import annotations

import math
import operator

import numpy as np
import torch

from xclim_tpu_torch.ops import _build
from xclim_tpu_torch.utils.profiling import span

__all__ = ["topk_rank_tables", "merge_rank_replaced_year_quantile",
           "merge_rank_replaced_year_quantile_plain", "table_in_shared",
           "topk_capacity"]

#: calls of merge_rank_replaced_year_quantile that ran the kernel
launches = 0
#: of those, the calls whose tables the kernel kept in shared memory
shared_launches = 0
#: and those whose tables and added samples it kept in global scratch
global_launches = 0
#: calls served with the plain twin (CPU tensors)
twin_calls = 0

#: most table slots of the shared-memory instance (48 KB a 128-lane block)
MAX_SHARED_K = 96
#: longest window the shared-memory instance sorts in registers
MAX_REGISTER_W = 16


def table_in_shared(K: int, w: int) -> bool:
    """Whether the kernel keeps each lane's table in shared memory and its
    added samples in registers (else both in global scratch)."""
    return K <= MAX_SHARED_K and w <= MAX_REGISTER_W


def topk_rank_tables(flat: torch.Tensor, year_id, k: int):
    """Top-k / bottom-k candidate tables for the year-replacement bootstrap
    (lanes-last layout).

    flat: (..., N, C) samples, NaN = missing; year_id: (N,) int year of each
    sample. Returns (topv, topyear, botv, botyear, nvalid): topv/botv are
    the k largest/smallest values per lane in descending/ascending order,
    shaped (..., C, k) (-inf/+inf where a lane has fewer than k valid
    values), topyear/botyear the year of each, nvalid (..., C) int32.
    """
    nan = torch.isnan(flat)
    lanes = flat.movedim(-2, -1)
    nanl = nan.movedim(-2, -1)
    topv, topi = torch.topk(torch.where(nanl, -torch.inf, lanes), k, dim=-1,
                            largest=True, sorted=True)
    botv, boti = torch.topk(torch.where(nanl, torch.inf, lanes), k, dim=-1,
                            largest=False, sorted=True)
    yid = torch.as_tensor(year_id, dtype=torch.int32, device=flat.device)
    nvalid = (~nan).sum(dim=-2, dtype=torch.int32)
    return topv, yid[topi], botv, yid[boti], nvalid


def _kept_table(table: torch.Tensor, tyear: torch.Tensor, b) -> torch.Tensor:
    """The table (descending) without year b's entries and without the
    infinite padding, compacted to the front and padded with -inf."""
    drop = ((tyear == b) | torch.isinf(table)).to(torch.int32)
    k = table.shape[-1]
    # the exclusive count of dropped entries before each slot; scanned over
    # the leading axis, which torch's scan serves far faster than a short
    # innermost one
    before = torch.cumsum(drop.movedim(-1, 0), dim=0,
                          dtype=torch.int32).movedim(0, -1) - drop
    pos = torch.arange(k, device=table.device) - before
    pos = torch.where(drop.bool(), k, pos).to(torch.int64)   # dropped -> spare slot
    out = torch.full(table.shape[:-1] + (k + 1,), -torch.inf,
                     dtype=table.dtype, device=table.device)
    return out.scatter(-1, pos, table)[..., :k]


def _merged(kept: torch.Tensor, added: torch.Tensor, j: torch.Tensor):
    """The j-th largest (0-based) of the union of ``kept`` (..., C, k) and
    ``added`` (..., C, w), both descending with -inf padding: the max over
    the splits t of min(kept[j - t], added[t - 1]) (the merge path: the top
    j+1 of the union are the top j+1-t of one list and the top t of the
    other for exactly one t). -inf where the union has no j-th element."""
    k, w = kept.shape[-1], added.shape[-1]
    t = torch.arange(w + 1, device=kept.device)
    idx = j.to(torch.int64)[..., None] - t                 # (..., C, w+1)
    shape = idx.shape[:-1] + (k,)
    xk = kept.expand(shape).gather(-1, idx.clamp(0, k - 1))
    xk = torch.where(idx < 0, torch.inf, torch.where(idx >= k, -torch.inf, xk))
    # t = 0 takes no added sample: its candidate is kept[j] itself
    return torch.maximum(xk[..., 0],
                         torch.minimum(xk[..., 1:], added).amax(dim=-1))


def _sort_desc(a: torch.Tensor) -> torch.Tensor:
    """``a`` (NaN-free) sorted descending along its last axis by an odd-even
    transposition network: w rounds of elementwise max/min (10 compare-
    exchanges for the usual 5-day window), far cheaper than a sort kernel
    over millions of w-element rows."""
    v = list(a.unbind(-1))
    w = len(v)
    for r in range(w):
        for i in range(r % 2, w - 1, 2):
            v[i], v[i + 1] = (torch.maximum(v[i], v[i + 1]),
                              torch.minimum(v[i], v[i + 1]))
    return torch.stack(v, dim=-1)


def merge_rank_replaced_year_quantile(topv, topyear, botv, botyear, nvalid,
                                      A_b, A_o, b, q: float,
                                      alpha: float = 1 / 3,
                                      beta: float = 1 / 3, *,
                                      samples: torch.Tensor | None = None
                                      ) -> torch.Tensor:
    """Quantile of the year-b-replaced multiset from the candidate tables,
    for every replacement: the kernel on a CUDA tensor, the twin
    :func:`merge_rank_replaced_year_quantile_plain` on a CPU one, with the
    same bits.

    topv/topyear/botv/botyear (..., C, K), nvalid (..., C) from
    :func:`topk_rank_tables`: floating values (float32 on the card, which
    the kernel reads; the twin takes any float dtype) and integer year
    tags. b: the removed year's tag.

    With ``samples`` (the in-base sample tensor (n_doy, nyears, w, C), any
    strides) and ``A_b = A_o = None``: year b of ``samples``
    is removed and every other year added in turn, with the tables (n_doy,
    C, K) and nvalid (n_doy, C) of that tensor. Returns (nyears - 1, n_doy,
    C), the positional form's bits for ``A_b = samples[:, b]`` and ``A_o``
    the other years in order; the kernel reads them in place.

    On the CPU only, the positional form: A_b, A_o (..., C, w)
    removed/added samples of the same kind, lanes-last, all broadcasting
    as in the twin (a leading replacement axis on ``A_o``). Returns the
    broadcast shape, in the values' dtype.

    Raises TypeError or ValueError before any work on wrong dtypes, shapes,
    devices or arguments (the positional form on the card among them),
    and RuntimeError if the launch fails.
    """
    global twin_calls
    with span("op.bootstrap"):
        b = operator.index(b)
        q, alpha, beta = float(q), float(alpha), float(beta)
        _check(topv, topyear, botv, botyear, nvalid, A_b, A_o, b, q, samples)
        if topv.device.type == "cpu":
            twin_calls += 1
            if samples is not None:
                A_b, A_o = _replacements(samples, b)
            return merge_rank_replaced_year_quantile_plain(
                topv, topyear, botv, botyear, nvalid, A_b, A_o, b, q,
                alpha=alpha, beta=beta)
        if topv.device.type != "cuda":
            raise ValueError(f"no bootstrap kernel for device {topv.device}")
        if samples is None:
            raise ValueError("the kernel takes the in-base samples as "
                             "samples=; the positional A_b, A_o form is "
                             "the CPU twin's")
        top = q >= 0.5
        tab, tyear = (topv, topyear) if top else (botv, botyear)
        return _launch_years(tab, tyear, nvalid, samples, b, top, q, alpha,
                             beta)


def _check(topv, topyear, botv, botyear, nvalid, A_b, A_o, b, q, samples):
    if samples is not None and (A_b is not None or A_o is not None):
        raise ValueError("pass either A_b and A_o, or samples=, not both")
    sample_args = {"samples": samples} if samples is not None else \
        {"A_b": A_b, "A_o": A_o}
    values = {"topv": topv, "botv": botv, **sample_args}
    tags = {"topyear": topyear, "botyear": botyear, "nvalid": nvalid}
    for name, t in {**values, **tags}.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    for name, t in values.items():
        if not t.dtype.is_floating_point:
            raise TypeError(f"{name} must hold floats, got {t.dtype}")
    for name, t in tags.items():
        if t.dtype.is_floating_point or t.dtype.is_complex \
                or t.dtype == torch.bool:
            raise TypeError(f"{name} must hold integers, got {t.dtype}")
    devices = {t.device for t in (*values.values(), *tags.values())}
    if len(devices) != 1:
        raise ValueError(f"the inputs lie on several devices: {devices}")
    if topv.device.type == "cuda":
        for name, t in values.items():
            if t.dtype != torch.float32:
                raise TypeError(f"{name} must be float32 on the card, got "
                                f"{t.dtype}")
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"q must lie in [0, 1], got {q}")
    if topv.ndim < 1 or topv.shape[-1] < 1:
        raise ValueError("the tables need a candidate axis of at least one")
    tables = (topv, topyear, botv, botyear)
    if len({t.shape for t in tables}) != 1:
        raise ValueError("topv, topyear, botv and botyear differ in shape: "
                         f"{[tuple(t.shape) for t in tables]}")
    if samples is not None:
        if samples.ndim != 4:
            raise ValueError("samples must be (n_doy, nyears, w, C), got "
                             f"{tuple(samples.shape)}")
        n_doy, ny, w, C = samples.shape
        if tuple(topv.shape[:-1]) != (n_doy, C) or \
                tuple(nvalid.shape) != (n_doy, C):
            raise ValueError(f"tables {tuple(topv.shape)} and nvalid "
                             f"{tuple(nvalid.shape)} do not match samples "
                             f"{tuple(samples.shape)}")
        if w < 1 or not 0 <= b < ny:
            raise ValueError(f"year {b} of {ny}, window {w}: no such "
                             "removal")
        return
    if A_b.ndim < 1 or A_o.ndim < 1 or A_b.shape[-1] != A_o.shape[-1] \
            or A_b.shape[-1] < 1:
        raise ValueError(f"A_b {tuple(A_b.shape)} and A_o "
                         f"{tuple(A_o.shape)} need one window axis of "
                         "at least one sample")
    try:
        torch.broadcast_shapes(topv.shape[:-1], nvalid.shape, A_b.shape[:-1],
                               A_o.shape[:-1])
    except RuntimeError as err:
        raise ValueError(f"the inputs do not broadcast: {err}") from None


def _replacements(samples, b):
    """A_b (n_doy, C, w) and A_o (nyears - 1, n_doy, C, w) of the keyword
    form, for the twin."""
    others = torch.as_tensor([o for o in range(samples.shape[1]) if o != b],
                             dtype=torch.int64, device=samples.device)
    return (samples[:, b].movedim(-1, -2),
            samples.index_select(1, others).permute(1, 0, 3, 2))


def _launch_years(tab, tyear, nvalid, samples, b, top, q, alpha, beta):
    global launches, shared_launches, global_launches
    n_doy, ny, w, C = samples.shape
    out = torch.empty((ny - 1, n_doy, C), dtype=torch.float32,
                      device=samples.device)
    lanes, O = n_doy * C, ny - 1
    if lanes == 0 or O == 0:
        return out
    K = tab.shape[-1]
    tab = tab.contiguous()
    tyear = tyear.to(torch.int32).contiguous()
    nvalid = nvalid.to(torch.int32).contiguous()
    # the one place that picks the instance: the kernel keeps the table in
    # shared memory exactly when it is handed no scratch
    shared = table_in_shared(K, w)
    scratch = None if shared else torch.empty(
        ((K + w) * lanes,), dtype=torch.float32, device=out.device)
    qf = np.float32(q)
    cq = np.float32(q * (1 - alpha - beta) + alpha)
    sd, sy, ss, sc = samples.stride()
    # year b is removed (skip b) and every other year of samples added;
    # the removed samples' strides (doy, window, cell), then the added
    # ones' (year, doy, window, cell)
    _build.launch("bootstrap", "xtt_bootstrap", "pppppppqiiiiiiiffqqqqqqq",
                  out.device, tab.data_ptr(), tyear.data_ptr(),
                  nvalid.data_ptr(), samples.select(1, b).data_ptr(),
                  samples.data_ptr(), out.data_ptr(),
                  0 if scratch is None else scratch.data_ptr(), lanes, C, K,
                  w, O, b, b, int(top), qf, cq, sd, ss, sc, sy, sd, ss, sc)
    launches += 1
    if shared:
        shared_launches += 1
    else:
        global_launches += 1
    return out


def merge_rank_replaced_year_quantile_plain(topv, topyear, botv, botyear,
                                            nvalid,
                                            A_b, A_o, b, q: float,
                                            alpha: float = 1 / 3,
                                            beta: float = 1 / 3
                                            ) -> torch.Tensor:
    """Plain PyTorch twin of :func:`merge_rank_replaced_year_quantile`
    (positional form), on any device: the quantile of the year-b-replaced
    multiset from the candidate tables.

    topv/topyear/botv/botyear/nvalid from :func:`topk_rank_tables` (they
    broadcast against the replacements: a leading replacement axis needs no
    copy of them); A_b, A_o: (..., C, w) removed/added samples, lanes-last;
    b: the removed year's index. Hyndman-Fan (alpha, beta) semantics of
    :func:`~xclim_tpu_torch.ops.quantile.nan_quantile`, with the reference's
    float32 op sequence: ``h = n*q + (q*(1-a-b)+a) - 1`` clipped to [0,
    n-1], and ``v0 + g*(v1 - v0)``.

    The needed order statistics of the modified multiset sit within
    ``(1-q)*n + 2`` ranks of the top (``q*n + 2`` of the bottom for q < 0.5);
    replacing one year removes at most w samples, so they lie in (table
    minus year b) + A_o when ``k >= J + w`` (:func:`topk_capacity`). The
    reference ranks that merge with a (k x w) comparison matrix; here the
    table minus year b is compacted once and the j-th element of the merge
    is read by the merge path, which picks the same element.
    """
    vb = (~torch.isnan(A_b)).sum(dim=-1, dtype=torch.int32)
    vo = (~torch.isnan(A_o)).sum(dim=-1, dtype=torch.int32)
    nmod_i = nvalid - vb + vo
    nmod = nmod_i.to(torch.float32)

    h = nmod * q + (q * (1 - alpha - beta) + alpha) - 1.0
    h = torch.minimum(torch.clamp(h, min=0.0), torch.clamp(nmod - 1.0, min=0.0))
    k0 = torch.floor(h).to(torch.int32)
    gam = h - k0.to(torch.float32)
    k1 = torch.minimum(k0 + 1, torch.clamp(nmod_i - 1, min=0))

    if q >= 0.5:
        sign, table, tyear = 1.0, topv, topyear
        j0, j1 = nmod_i - 1 - k0, nmod_i - 1 - k1
    else:
        # the bottom table ascending is the negated values descending
        sign, table, tyear = -1.0, -botv, botyear
        j0, j1 = k0, k1
    kept = _kept_table(table, tyear, b)
    added = _sort_desc(torch.where(torch.isnan(A_o) | torch.isinf(A_o),
                                   -torch.inf, sign * A_o))
    m0 = _merged(kept, added, j0.clamp(min=0))
    m1 = _merged(kept, added, j1.clamp(min=0))
    v0, v1 = sign * m0, sign * m1
    out = v0 + gam * (v1 - v0)
    out = torch.where(nmod_i <= 0, torch.nan, out)
    hit = (m0 > -torch.inf) & (m1 > -torch.inf)
    return torch.where(hit, out, torch.nan)


def topk_capacity(nmax: int, w: int, q: float) -> int:
    """Candidate-table size k that makes the table route exact for samples
    of at most `nmax` valid values, `w`-sample replacements and quantile
    `q`."""
    tail = (1 - q) if q >= 0.5 else q
    return int(math.ceil(tail * nmax)) + 2 + w
