"""The numbers that decide ``correct``, and their limits.

A training cell compares the program's first three steps with the plain
reference's, from the same inputs and initial weights:

* ``loss_gap``: ``|L_prog - L_ref| / |L_ref|`` of the first step's loss
  (the later steps' losses carry the noise of Adam's first updates, see
  :func:`look_readings`);
* ``grad_gap``: the first gradient as Adam got it (its first moment after
  one step, over ``1 - beta1``), leaf by leaf: ``| |g_prog| - |g_ref| |``
  over the larger of ``|g_ref|`` of that leaf and of the median leaf, and
  the worst of the output layer's leaves taken. A pre-activation within
  rounding of zero takes the other side of a ReLU on one side, and the
  gradient of every leaf below that ReLU carries the flip: their gaps
  swing by two decades from seed to seed, up to the control's. The output
  layer's gradient passes no ReLU mask and reads steadily (see
  :func:`look_readings`); the other leaves' gradients are judged through
  ``change_gap``;
* ``change_gap``: the parameters' change over the three steps, read before
  the fourth, leaf by leaf in the same way, and the median leaf's gap
  taken: Adam's first updates are about ``lr * sign(g)``, so a gradient
  element within rounding of zero can move the other way on one side, and
  the worst leaf carries that noise. Leaves whose reference gradient is
  under a thousandth of the median leaf's move under Adam by round-off
  alone and are left out of it.

The reference adds exact checks of what it can judge on its own (counts
that must be 0), and may add numbers that must reach a floor
(``{"min": ...}``). A workload file gives each number its limit:
``{"max": v}`` or ``{"min": v}``.
"""

import math

import torch

NOUGHT = 1e-3  # of the median leaf's reference gradient


def _norms(leaves):
    return [float(torch.linalg.vector_norm(t.double())) for t in leaves]


def _median(values):
    s = sorted(values)
    m = len(s) // 2
    return s[m] if len(s) % 2 else 0.5 * (s[m - 1] + s[m])


def leaf_gaps(prog, ref, keep=None) -> list:
    """Each leaf's ``| |p| - |r| |`` over ``max(|r|, median |r|)``, over
    the leaves ``keep`` names (default: all), in leaf order."""
    pn, rn = _norms(prog), _norms(ref)
    med = _median(rn)
    gaps = []
    for i in (range(len(rn)) if keep is None else keep):
        denom = max(rn[i], med)
        gaps.append(abs(pn[i] - rn[i]) / denom if denom > 0 else (
            0.0 if pn[i] == 0 else math.inf))
    return gaps


def _loss_gap(p: float, r: float) -> float:
    if not math.isfinite(p):
        return math.inf
    return abs(p - r) / abs(r) if r != 0 else abs(p)


def _kept(ref: dict) -> list:
    rn = _norms(ref['grads'])
    med = _median(rn)
    return [i for i, v in enumerate(rn) if v >= NOUGHT * med]


def training_readings(prog: dict, ref: dict, output_leaves: int) -> dict:
    """``prog`` and ``ref`` each hold ``losses`` (three floats), ``grads``
    (the first gradient, a tensor a leaf) and ``change`` (parameters after
    three steps minus the initial ones, a tensor a leaf), leaves in the
    same order, the output layer's ``output_leaves`` last."""
    n = len(ref['grads'])
    return {
        'loss_gap': _loss_gap(prog['losses'][0], ref['losses'][0]),
        'grad_gap': max(leaf_gaps(prog['grads'], ref['grads'],
                                  range(n - output_leaves, n))),
        'change_gap': _median(leaf_gaps(prog['change'], ref['change'],
                                        _kept(ref))),
    }


def look_readings(prog: dict, ref: dict, lr: float) -> dict:
    """What a calibration looks at beside the numbers compared: each
    step's loss gap, each leaf's first-gradient gap, the worst leaf's
    change gap and that leaf, and how many parameters the two sides moved
    by more than ``lr`` apart (an Adam update that went the other way)."""
    keep = _kept(ref)
    gaps = leaf_gaps(prog['change'], ref['change'], keep)
    flipped = sum(int(((p.double() - r.double()).abs() > lr).sum())
                  for p, r in zip(prog['change'], ref['change']))
    return {'loss_gap_steps': [_loss_gap(p, r) for p, r in zip(
                prog['losses'], ref['losses'])],
            'grad_gap_leaves': leaf_gaps(prog['grads'], ref['grads']),
            'change_gap_worst': max(gaps),
            'change_worst_leaf': keep[max(range(len(gaps)),
                                          key=gaps.__getitem__)],
            'flipped_updates': flipped}


def judge(readings: dict, limits: dict):
    """``(correct, checks)``: every reading against its limit, in the
    order of ``limits``. A reading without a limit, a limit without a
    reading, and a reading that is not a finite number all fail."""
    checks = {}
    correct = True
    for name, value in readings.items():
        lim = limits.get(name)
        ok = lim is not None and isinstance(value, (int, float)) and \
            math.isfinite(value)
        if ok and 'max' in lim:
            ok = value <= lim['max']
        if ok and 'min' in lim:
            ok = value >= lim['min']
        shown = (lim or {}).get('max', (lim or {}).get('min'))
        checks[name] = {'value': value, 'limit': shown,
                        'ok': bool(ok)}
        correct &= bool(ok)
    for name in limits:
        if name not in readings:
            checks[name] = {'value': None, 'limit': None, 'ok': False}
            correct = False
    return correct, checks


def check_lines(checks: dict):
    """One line a number: its name, its value, its limit and the
    verdict."""
    for name, c in checks.items():
        yield (f"check {name} {c['value']!r} limit {c['limit']!r} "
               f"{'ok' if c['ok'] else 'FAILED'}")
