"""Load curves — sampled time series driving BCs/loads.

Counterpart of ``nlpartsol_tpu/utils/curves.py`` (numpy only; the port keeps
its own copy because importing the JAX package imports JAX).  Reference:
NL-PartSol's src/InOutFun/ReadCurve.c — a curve is a
(NumTimeStep,) array built by summing primitive shapes:
  CONSTANT_CURVE SCALE#v          f[i] += v                      (:138-183)
  RAMP_CURVE SCALE#v              f[i]  = v·i/N                  (:185-228)
  HEAVISIDE_CURVE SCALE#v Tc#t    f[i] += v·(i > t)              (:230-290)
  DELTA_CURVE SCALE#v Tc#t        f[i] += v·(i == t)             (:292-350)
  HAT_CURVE SCALE#v T0#a T1#b     f[i] += v·(a < i ≤ b)          (:352-420)
  CUSTOM_CURVE (one value/line)   f[i] += file[i]                (:76-83)

Curves are plain numpy arrays here (host-side config data; the driver
stacks them into one device table and indexes it per step).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "constant",
    "ramp",
    "heaviside",
    "delta",
    "hat",
    "custom",
    "parse_curve_lines",
]


def constant(n: int, scale: float) -> np.ndarray:
    return np.full(n, scale, np.float64)


def ramp(n: int, scale: float) -> np.ndarray:
    return scale * np.arange(n, dtype=np.float64) / n


def heaviside(n: int, scale: float, tc: int) -> np.ndarray:
    f = np.zeros(n)
    f[np.arange(n) > tc] = scale
    return f


def delta(n: int, scale: float, tc: int) -> np.ndarray:
    f = np.zeros(n)
    if 0 <= int(tc) < n:
        f[int(tc)] = scale
    return f


def hat(n: int, scale: float, t0: int, t1: int) -> np.ndarray:
    f = np.zeros(n)
    i = np.arange(n)
    f[(i > t0) & (i <= t1)] = scale
    return f


def custom(n: int, values) -> np.ndarray:
    v = np.asarray(values, np.float64)
    f = np.zeros(n)
    f[: min(n, len(v))] = v[:n]
    return f


def _props(tokens):
    """Parse 'KEY#value' tokens (the reference's '#' property syntax)."""
    out = {}
    for t in tokens:
        if "#" in t:
            k, v = t.split("#", 1)
            out[k] = float(v)
    return out


def parse_curve_lines(lines, n: int) -> np.ndarray:
    """Build a curve from reference-format lines (ReadCurve.c:52-131)."""
    f = np.zeros(n)
    it = iter(lines)
    for line in it:
        toks = line.split()
        if not toks or toks[0].startswith("#"):
            continue
        kw = toks[0]
        p = _props(toks[1:])
        if kw == "DAT_CURVE":
            # mandatory header in reference curve files: 'DAT_CURVE NUM#n'
            # allocates the curve (ReadCurve.c:52-70).  Our curves are sized
            # by the solver's N, so the header is metadata only; a NUM
            # differing from N would change the reference's active-step
            # window (active_direction + IMIN) — warn loudly.
            num = int(p.get("NUM", n))
            if num != n:
                import warnings

                warnings.warn(
                    f"curve DAT_CURVE NUM#{num} != solver N={n}: the "
                    f"reference would deactivate this BC after step {num}"
                )
            continue
        if kw == "CONSTANT_CURVE":
            f += constant(n, p["SCALE"])
        elif kw == "RAMP_CURVE":
            f = ramp(n, p["SCALE"])
        elif kw == "HEAVISIDE_CURVE":
            f += heaviside(n, p["SCALE"], int(p["Tc"]))
        elif kw == "DELTA_CURVE":
            f += delta(n, p["SCALE"], int(p["Tc"]))
        elif kw == "HAT_CURVE":
            f += hat(n, p["SCALE"], int(p["T0"]), int(p["T1"]))
        elif kw == "CUSTOM_CURVE":
            vals = []
            for _ in range(n):
                try:
                    vals.append(float(next(it).split()[0]))
                except StopIteration:
                    break
            f += custom(n, vals)
        else:
            raise ValueError(f"unknown curve keyword: {kw}")
    return f
