"""Communication-compression configuration (the paper's per-site knobs).

A ``CommConfig`` describes how a tensor is compressed before it crosses a
link: bit width (1..8), quantization group size (128 for high bits, 32
for low bits, per the paper), spike reserving, integer-log scales
(``scale_int``), the collective schedule and the codec backend.

The wire layout (``WireLayout``) is the single source of truth for where
every section of the on-link buffer lives::

    [plane 0 | plane 1 | ... | scale | zero | spike vals | spike idx]

It is byte-for-byte the layout of the JAX package, so a buffer written by
either side decodes on the other.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional, Tuple

# Bit-splitting decomposition of every supported width into regular units
# (paper Fig. 3): 4- and 2-bit regular parts plus 1/2-bit extra planes.
BIT_UNITS = {
    1: (1,),
    2: (2,),
    3: (2, 1),
    4: (4,),
    5: (4, 1),
    6: (4, 2),
    7: (4, 2, 1),
    8: (8,),
}

# Collective schedules. "nccl" is the exact uncompressed baseline,
# "two_step" the Flash AllReduce over library collectives, "fused" the
# codec phases run as fused kernels around the hop. The hierarchical
# schedules are accepted so that policy files load; this package runs
# them only on a single axis, where they reduce to the two-step.
SCHEMES = ("nccl", "two_step", "fused", "hierarchical", "hier_pp")

# Wire-codec backends: "ref" runs the plain PyTorch codec on any device,
# "cuda" the hand-written CUDA kernels (CUDA tensors only), "auto" the
# kernels for a CUDA tensor and the plain codec for a CPU tensor.
BACKENDS = ("ref", "cuda", "auto")

# Size of the self-describing frame header (core/frame.py), byte for byte
# the JAX package's.
FRAME_HEADER_BYTES = 16


class Section(NamedTuple):
    """One contiguous byte span of the wire buffer."""
    offset: int
    nbytes: int

    @property
    def end(self) -> int:
        return self.offset + self.nbytes


class WireLayout(NamedTuple):
    """Static byte-offset table of the wire format for ``n`` numbers.

    ``spike_vals`` / ``spike_idx`` are ``None`` when spike reserving is
    off.
    """
    n: int
    planes: Tuple[Tuple[int, Section], ...]   # ((unit, span), ...)
    scale: Section
    zero: Section
    spike_vals: Optional[Section]
    spike_idx: Optional[Section]
    total: int


_META_ITEMSIZE = 2      # BF16/FP16 wire metadata (paper baseline)


@functools.lru_cache(maxsize=None)
def _wire_layout(n: int, bits: int, group: int, spike: bool,
                 scale_int: bool) -> WireLayout:
    assert n % group == 0, (n, group)
    g = n // group
    off = 0
    planes = []
    for unit in BIT_UNITS[bits]:
        nbytes = (n * unit + 7) // 8
        planes.append((unit, Section(off, nbytes)))
        off += nbytes
    meta = 1 if scale_int else _META_ITEMSIZE
    scale = Section(off, g * meta)
    off = scale.end
    zero = Section(off, g * meta)
    off = zero.end
    spike_vals = spike_idx = None
    if spike:
        # 2 spikes per group: values always meta-exact (paper Fig. 5c),
        # indices int8 with scale_int, meta-width otherwise (Table 4).
        spike_vals = Section(off, 2 * g * _META_ITEMSIZE)
        off = spike_vals.end
        spike_idx = Section(off, 2 * g * (1 if scale_int
                                          else _META_ITEMSIZE))
        off = spike_idx.end
    return WireLayout(n, tuple(planes), scale, zero, spike_vals,
                      spike_idx, off)


@dataclasses.dataclass(frozen=True)
class CommConfig:
    """Compression + schedule config for one communication site."""

    enabled: bool = True
    bits: int = 8                 # any of 1..8
    group: int = 128              # quantization group size (paper: 128 or 32)
    spike: bool = False           # spike reserving (paper: for INT2/3)
    # Randomized Hadamard rotation per group before quantization; an
    # alternative to spike reserving that needs a power-of-two group.
    rotation: bool = False
    scale_int: bool = False       # integer log2 scale/zero codec (Eq. 1)
    theta: int = 10               # scale_int linear upscaling factor
    scheme: str = "two_step"      # collective schedule
    pipeline_chunks: int = 4      # microchunks for hier_pp
    meta_dtype: str = "bfloat16"  # wire meta dtype when scale_int is off
    backend: str = "auto"         # codec implementation, see BACKENDS
    # Self-describing frame header + CRC32C around each wire row
    # (core/frame.py); the bridge tier's two-step schedules only.
    framed: bool = False

    def __post_init__(self):
        if self.enabled:
            assert self.bits in BIT_UNITS, f"unsupported bits={self.bits}"
            assert self.group > 2, "group must hold at least 3 values"
            assert self.scheme in SCHEMES, f"unknown scheme {self.scheme}"
            assert self.backend in BACKENDS, \
                f"unknown backend {self.backend}"
            if self.spike:
                # 2 spikes per group are removed; need codes for the rest.
                assert self.group >= 4
                # In-group spike indices are one byte on the wire under
                # scale_int: a larger group would wrap them.
                assert self.group <= 128, \
                    f"spike reserving needs group <= 128 (int8 " \
                    f"in-group indices on the wire), got {self.group}"
            if self.rotation:
                assert not self.spike, \
                    "rotation replaces spike reserving (pick one)"
                assert self.group & (self.group - 1) == 0, \
                    f"rotation needs a power-of-two group, " \
                    f"got {self.group}"
            if self.framed:
                assert self.scheme != "fused", \
                    "framed wire is not supported by the fused RDMA " \
                    "kernels (use an XLA scheme for the bridge tier)"

    def with_backend(self, backend: str) -> "CommConfig":
        """Same config routed through a different codec backend."""
        return dataclasses.replace(self, backend=backend)

    def with_rotation(self, on: bool = True) -> "CommConfig":
        """Same transport with the Hadamard-rotated quantizer toggled.

        Turning rotation on drops spike reserving (the two are exclusive
        outlier treatments: rotation makes the reserved sections
        redundant and the wire shorter)."""
        return dataclasses.replace(
            self, rotation=on, spike=False if on else self.spike)

    def with_scheme(self, scheme: str) -> "CommConfig":
        """Same config routed through a different collective schedule."""
        return dataclasses.replace(self, scheme=scheme)

    def with_framed(self, on: bool = True) -> "CommConfig":
        """Same config with the self-describing frame header toggled."""
        return dataclasses.replace(self, framed=on)

    def with_bits(self, bits: int) -> "CommConfig":
        """Same transport at another width, paper defaults for group and
        spike (g128 for >= 5 bits, g32 + spike at <= 2 bits below)."""
        if bits >= 5:
            return dataclasses.replace(self, bits=bits, group=128,
                                       spike=False)
        return dataclasses.replace(self, bits=bits, group=32,
                                   spike=bits <= 2 and not self.rotation)

    # ----- wire-size accounting -------------------------------------------

    def wire_layout(self, n: int) -> WireLayout:
        """Static byte-offset table of the wire format for ``n`` numbers."""
        return _wire_layout(n, self.bits, self.group, self.spike,
                            self.scale_int)

    def wire_bytes(self, n: int) -> int:
        total = self.wire_layout(n).total
        return total + FRAME_HEADER_BYTES if self.framed else total

    def compression_ratio(self, n: int) -> float:
        return (2.0 * n) / self.wire_bytes(n)   # vs BF16


def default_comm_config(bits: int, scheme: str = "two_step",
                        scale_int: bool = False,
                        backend: str = "auto") -> CommConfig:
    """Paper defaults (Setup): g128 for INT8/6/5, g32 for INT4/3/2, spike
    reserving at INT2."""
    if bits >= 5:
        return CommConfig(bits=bits, group=128, spike=False,
                          scale_int=scale_int, scheme=scheme,
                          backend=backend)
    return CommConfig(bits=bits, group=32, spike=bits <= 2,
                      scale_int=scale_int, scheme=scheme, backend=backend)


NO_COMPRESSION = CommConfig(enabled=False, scheme="nccl")
