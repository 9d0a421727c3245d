"""Teacher-weight warm start for plain (CLIP-architecture) students.

Port of ``distillclip_tpu/models/teacher_init.py``: copy the teacher's weights
into a student of the same width with fewer layers, remapping the blocks by an
``init_type``:

* ``begin``: student block i <- teacher block i
* ``end``:   student block i <- teacher block (tea_n - stu_n + i)
* ``mid``:   student block i <- teacher block (i * step)

Parameters outside the blocks that both towers have, with the same shape, are
copied directly.  The towers are state dicts by the port's names (the
``visual`` or ``text`` scope: ``transformer.resblocks.{i}.<leaf>``).
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Optional

import torch

_BLOCK = re.compile(r"^transformer\.resblocks\.(\d+)\.(.+)$")


def _map_layer(init_type: str, stu_n: int, tea_n: int,
               step: Optional[int] = None) -> Callable[[int], int]:
    if init_type == "begin":
        return lambda i: i
    if init_type == "end":
        return lambda i: tea_n - stu_n + i
    if init_type == "mid":
        s = step if step is not None else max(1, tea_n // stu_n)
        return lambda i: i * s
    raise ValueError(f"the init_type should be begin, end, and mid, but got {init_type}")


def _count_blocks(tower: Dict[str, torch.Tensor]) -> int:
    return len({m.group(1) for m in map(_BLOCK.match, tower) if m})


def init_layers_with_teacher(student_tower: Dict[str, torch.Tensor],
                             teacher_tower: Dict[str, torch.Tensor],
                             init_type: Optional[str],
                             step: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """A new student state dict (fresh tensors); shapes must match for a leaf
    to be taken from the teacher, layer counts may differ."""
    if init_type is None:
        return student_tower
    stu_n, tea_n = _count_blocks(student_tower), _count_blocks(teacher_tower)
    mapper = _map_layer(init_type, stu_n, tea_n, step)
    out = {}
    for name, value in student_tower.items():
        m = _BLOCK.match(name)
        src = name
        if m:
            tea_idx = mapper(int(m.group(1)))
            if not 0 <= tea_idx < tea_n:
                raise ValueError(f"mapped teacher layer {tea_idx} out of range [0,{tea_n})")
            src = f"transformer.resblocks.{tea_idx}.{m.group(2)}"
        tea = teacher_tower.get(src)
        take = tea is not None and tea.shape == value.shape
        out[name] = (tea.to(value.dtype) if take else value).detach().clone()
    return out
