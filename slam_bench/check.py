"""What decides `correct`: the timed path's own outputs, sampled from the
seed inside the window, held against the plain reference.

A configuration's kind (`compare` in `harness/<kind>.py`) gives every
number it compares, from its probe's captures; each number that has a
limit in the cell's file (`limits`) is held to it, and a number without
one is recorded beside them, not compared (`judge`).

With `control=True` a kind's `compare` puts the reference in the
program's place one precision down and holds it to the reference (the
control, which has to come out not correct): every floating input and
output rounded to bfloat16 (`lower`).
"""

from __future__ import annotations

import numpy as np
import torch


def lower(x, on: bool):
    """`x` rounded to bfloat16 and back, where `on` and `x` is floating."""
    if not on:
        return x
    if isinstance(x, torch.Tensor):
        if x.is_floating_point():
            return x.to(torch.bfloat16).to(x.dtype)
        return x
    arr = np.asarray(x)
    if arr.dtype.kind == "f":
        return torch.from_numpy(np.asarray(arr, np.float32)).to(torch.bfloat16).to(torch.float32).numpy().astype(arr.dtype)
    return x


def judge(numbers: dict, limits: dict):
    """(correct, compared, recorded): every number that has a limit in
    the cell's file at or under it; [(name, value, limit)] of those, and
    {name: value} of the numbers the cell records without comparing."""
    rows = [(n, v, limits[n]) for n, v in numbers.items() if n in limits]
    recorded = {n: v for n, v in numbers.items() if n not in limits}
    return all(v <= lim for _, v, lim in rows), rows, recorded
