"""The quantizer each reference conv passes its input and weight through.

:data:`IDENTITY` leaves both as they are: the float32 reference.
:class:`FakeQuant` rounds them to a signed integer grid and back, which is
what an integer kernel computes up to the order of its sums: weights per
output channel, activations per tensor, each scale the largest magnitude
over the levels (``2**(bits-1) - 1``). The control of a configuration
whose reference runs in float32 (one without a ``stated`` network) is that
reference at the precisions one step below those the configuration states
(``control_bits`` in the configuration file).
"""

from __future__ import annotations

from typing import Dict

import torch


class _Identity:
    def act(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return x

    def weight(self, name: str, w: torch.Tensor) -> torch.Tensor:
        return w


IDENTITY = _Identity()


def fake_quant(x: torch.Tensor, bits: int, dim=None) -> torch.Tensor:
    """``x`` rounded to ``bits``-bit signed levels, per tensor (``dim``
    None) or per slice along ``dim``."""
    top = 2 ** (bits - 1) - 1
    if dim is None:
        amax = x.abs().amax()
    else:
        amax = x.abs().amax(dim=[d for d in range(x.ndim) if d != dim],
                            keepdim=True)
    scale = torch.clamp(amax, min=1e-12) / top
    return torch.clamp(torch.round(x / scale), -top - 1, top) * scale


class FakeQuant:
    """``bits[name]`` bits for the conv ``name``, ``default`` for the rest."""

    def __init__(self, default: int, bits: Dict[str, int] = None):
        self.default = default
        self.bits = dict(bits or {})

    def _bits(self, name: str) -> int:
        return self.bits.get(name, self.default)

    def act(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return fake_quant(x, self._bits(name))

    def weight(self, name: str, w: torch.Tensor) -> torch.Tensor:
        return fake_quant(w, self._bits(name), dim=0)
