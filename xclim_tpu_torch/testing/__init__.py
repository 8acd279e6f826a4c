"""Checks that hold the port's results to independent float64 replays.

:func:`check_chill_portions` holds the dynamic chill-portion model
(``indices._agro``) on any device to a float64 replay on the CPU. The model
banks a portion only in the hours where its intermediate product E reaches
1, so an E within float32 rounding of 1 banks on one device and not on
another, and the two devices' period sums then differ by part of a portion
or more. The replay follows the device's own banking decision at every
hour, accepts a decision that differs from float64's own E >= 1 only where
the float64 E lies within ``flip_tol`` of 1, and holds the period sums to
``rtol``: each device is held to float64 as far as float32 rounding
reaches, its flips included, and a flip away from E = 1 is a failure.
"""

from __future__ import annotations

import torch

__all__ = ["chill_replay", "check_chill_portions"]


def chill_replay(tas_K, bank=None):
    """Float64 replay on the CPU of the dynamic chill model for hourly
    ``tas_K`` [K] with time first: (E, xi, delta), the intermediate product
    after each hour, the hour's portion factor and the portion banked.
    Where ``bank`` (bool, time first) is given a portion is banked by its
    decision, else where E >= 1 (Fishman et al. 1987;
    xclim:_agro.py:1436-1535)."""
    e0, e1 = 4153.5, 12888.8
    a0, a1 = 139500.0, 2.567e18
    slp, tetmlt = 1.6, 277.0
    x = tas_K.detach().to("cpu", torch.float64)
    sr = torch.exp(slp * tetmlt * (x - tetmlt) / x)
    xi = sr / (1 + sr)
    xs = a0 / a1 * torch.exp((e1 - e0) / x)
    decay = torch.exp(-a1 * torch.exp(-e1 / x))
    E = torch.empty_like(x)
    banked = torch.empty(x.shape, dtype=torch.bool)
    prev_E = torch.zeros(x.shape[1:], dtype=torch.float64)
    prev_bank = torch.zeros(x.shape[1:], dtype=torch.bool)
    prev_xi = torch.zeros_like(prev_E)
    for t in range(x.shape[0]):
        s = torch.where(prev_bank, prev_E - prev_E * prev_xi, prev_E)
        prev_E = xs[t] - (xs[t] - s) * decay[t]
        E[t] = prev_E
        prev_bank = bank[t] if bank is not None else prev_E >= 1
        banked[t] = prev_bank
        prev_xi = xi[t]
    return E, xi, torch.where(banked, E * xi, 0.0)


def check_chill_portions(tas, freq="YS", rtol=1e-5, atol=1e-6,
                         flip_tol=1e-5):
    """Chill portions of hourly ``tas`` on its device, held to the float64
    replay under the device's banking decisions. A NaN hour makes E NaN
    from there on in both, and neither banks again.

    Returns (portions, report). ``report``: ``bank`` and ``E``, the
    device's decisions and intermediate product (CPU, time first); ``E64``,
    the replay's; ``flips``, the hours whose decision differs from
    float64's own E >= 1, and ``flip_gap``, the largest |E64 - 1| there;
    ``replay``, the replay's period sums (period first), and
    ``max_abs_err``/``max_rel_err`` of the device's sums against them.
    Raises AssertionError for a flip gap past ``flip_tol`` or a period sum
    off by more than ``atol + rtol * |replay|``.
    """
    from xclim_tpu_torch.core.units import convert_units_to
    from xclim_tpu_torch.indices import _agro

    tk = convert_units_to(tas, "K")
    x = torch.movedim(tk.data, tk.time_axis, 0)
    inter, _ = _agro._chill_intermediate(x)
    bank = (inter >= 1).cpu()
    E64, _, delta = chill_replay(x, bank)
    flips = bank != (E64 >= 1)
    gap = float((E64[flips] - 1).abs().max()) if bool(flips.any()) else 0.0
    if gap > flip_tol:
        raise AssertionError(f"chill portions: a banking decision differs "
                             f"from float64's where |E64 - 1| = {gap:.3g} "
                             f"> {flip_tol}")
    out = _agro.chill_portions(tas, freq=freq)
    spec = tk.segments(freq)
    want = torch.stack([delta[int(s):int(s) + int(c)].sum(0)
                        for s, c in zip(spec.starts, spec.counts)])
    got = torch.movedim(out.data, out.time_axis, 0).cpu().double()
    err = (got - want).abs()
    rel = float((err / want.abs().clamp(min=atol)).max())
    bad = err > atol + rtol * want.abs()
    if bool(bad.any()):
        raise AssertionError(f"chill portions: {int(bad.sum())} period sums "
                             f"beyond rtol {rtol} atol {atol} of the float64 "
                             f"replay, max abs err {float(err.max())}")
    return out, {"bank": bank, "E": inter.cpu(), "E64": E64,
                 "flips": int(flips.sum()), "flip_gap": gap, "replay": want,
                 "max_abs_err": float(err.max()), "max_rel_err": rel}
