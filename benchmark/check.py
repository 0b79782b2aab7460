"""What decides ``correct``: the timed path's planes against the reference.

During the window a :class:`Sample` keeps, drawn from the seed, a fixed
number of the images the timed path returned (reservoir sampling: every
image of the window is as likely to be kept). Once the window has closed,
:func:`judge` decodes each kept image's pool image with the reference,
moves its rows where the request moved them, and compares plane by plane.

The configuration's guarantee is bit-exactness against the sequential
integer decoder, so each number compared has the limit 0:

- ``wrong_values``: plane values that differ, every value of a plane whose
  shape or type differs, and every value of a plane that is missing;
- ``wrong_planes``: planes missing, extra, or of another shape or type;
- ``failed_requests``: requests that raised instead of answering.

``images_checked`` has to be at least 1.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .inputs import seed_key
from .reference.rows import Rows
from .reference.golden import decode
from .reference.parallel import decode_all
from .traffic import Key

LIMITS = {"wrong_values": 0, "wrong_planes": 0, "failed_requests": 0}


class Sample:
    """Reservoir of `k` (key, planes) pairs over the images offered, in an
    order drawn from the seed.

    With `slot_bytes`, planes that are uint8 tensors are copied into one of
    `k` slots of that many bytes, allocated here on `device` once: the
    program's outputs are not held past their request, and the run's
    memory peak less the slots is the program's own. Other planes (numpy
    arrays) are kept as they came."""

    def __init__(self, k: int, seed: int, slot_bytes: int = 0, device=None):
        self.k = k
        self.rng = np.random.default_rng(seed_key(seed, 3))
        self.seen = 0
        self.kept: List[Tuple[Key, list]] = []
        self.slots = None
        if slot_bytes and device is not None:
            import torch

            self.slots = torch.empty((k, slot_bytes), dtype=torch.uint8,
                                     device=device)

    def _keep(self, j: int, planes):
        """`planes` as slot `j` holds them, where they fit there."""
        if self.slots is None or planes is None:
            return planes
        import torch

        flat, at, out = self.slots[j], 0, []
        for p in planes:
            if not isinstance(p, torch.Tensor) or p.dtype != torch.uint8 \
                    or at + p.numel() > flat.numel():
                return planes
            dst = flat[at:at + p.numel()].view(p.shape)
            dst.copy_(p)
            out.append(dst)
            at += p.numel()
        return out

    def offer(self, key: Key, planes) -> None:
        self.seen += 1
        if len(self.kept) < self.k:
            self.kept.append((key, self._keep(len(self.kept), planes)))
            return
        j = int(self.rng.integers(self.seen))
        if j < self.k:
            self.kept[j] = (key, self._keep(j, planes))


def compare(got: Sequence, want: Sequence[np.ndarray]) -> Tuple[int, int]:
    """(wrong values, wrong planes) of one image's planes."""
    values = planes = 0
    for i in range(max(len(got), len(want))):
        if i >= len(got) or i >= len(want):
            planes += 1
            values += want[i].size if i < len(want) else got[i].size
            continue
        g, w = np.asarray(got[i]), want[i]
        if g.shape != w.shape or g.dtype != w.dtype:
            planes += 1
            values += w.size
            continue
        values += int(np.count_nonzero(g != w))
    return values, planes


def reference_planes(pool_datas: Sequence[bytes], keys: Sequence[Key],
                     rows: Optional[List[Rows]], workers: int,
                     decoder=decode) -> Dict[Key, List[np.ndarray]]:
    """The reference's planes of each key: its pool image decoded once by
    `decoder` (the reference's; the control passes its own), its rows moved
    as the request moved them."""
    need = sorted({i for i, _ in keys})
    base = dict(zip(need, decode_all([pool_datas[i] for i in need], workers,
                                     decoder)))
    return {key: (rows[key[0]].permute_planes(base[key[0]], key[1])
                  if key[1] is not None else base[key[0]])
            for key in keys}


def judge(kept: Sequence[Tuple[Key, list]], want: Dict[Key, list],
          failed: int) -> Dict[str, Dict]:
    """The numbers compared, each with its limit."""
    values = planes = 0
    for key, got in kept:
        v, p = compare(got, want[key])
        values += v
        planes += p
    numbers = dict(wrong_values=values, wrong_planes=planes,
                   failed_requests=failed)
    out = {k: {"value": v, "max": LIMITS[k]} for k, v in numbers.items()}
    out["images_checked"] = {"value": len(kept), "min": 1}
    return out


def passed(checks: Dict[str, Dict]) -> bool:
    return all(c["value"] <= c["max"] if "max" in c else c["value"] >= c["min"]
               for c in checks.values())


def lines(checks: Dict[str, Dict]) -> List[str]:
    """One line per number compared, with its limit."""
    return [f"check {name}: {c['value']} "
            + (f"<= {c['max']}" if "max" in c else f">= {c['min']}")
            for name, c in checks.items()]
