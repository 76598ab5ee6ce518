"""Diagnostics and the rule registry for the comm-safety analyzer.

The port's copy of the JAX package's ``analysis/report.py``. Every
checker in :mod:`repro_torch.analysis` reports through
:class:`Diagnostic` values carrying a rule id from :data:`RULES` — one
stable, greppable identifier per failure class, so mutation fixtures can
assert that exactly *their* rule fired and CI logs stay searchable.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, List, Tuple

#: rule id -> one-line description (the README "rules table" source).
RULES = {
    # choreography (repro_torch.analysis.choreography)
    "CHOREO-DEADLOCK": "N-rank semaphore simulation stalls: a rank "
                       "blocks forever on a barrier or DMA wait",
    "CHOREO-SLOT": "send/receive DMA semaphore slots are not uniquely "
                   "paired per descriptor (a wait could certify a "
                   "different peer's transfer)",
    "CHOREO-SEM": "barrier signal count does not match the wait count "
                  "(stall, or stale residue poisoning the next use)",
    "CHOREO-RACE": "buffer lifetime race: RDMA push before the liveness "
                   "barrier, read of a landing buffer before its waits, "
                   "or push of an unwritten staging buffer",
    "CHOREO-BOUNDS": "push row or semaphore slot outside the declared "
                     "buffer/semaphore shape",
    "CHOREO-ID": "barrier collective_id collision between kernels live "
                 "in one compiled program",
    # wire layout (repro_torch.analysis.layout)
    "LAYOUT-OVERLAP": "two wire-buffer sections overlap",
    "LAYOUT-GAP": "wire-buffer sections leave an unaddressed byte gap",
    "LAYOUT-BOUNDS": "a wire-buffer section runs past the declared "
                     "total (or starts before offset 0)",
    "LAYOUT-LANES": "wire row width is not 128-lane aligned (transport "
                    "tiling may pad on real hardware; warning)",
    "LAYOUT-SPIKEIDX": "spike-index wire section cannot address every "
                       "in-group position (group exceeds the 1-byte "
                       "index range — indices would silently wrap)",
    # self-describing frames (repro_torch.analysis.frames)
    "FRAME-HEADER": "frame header disagrees with the config's wire "
                    "layout (bits/group/flags/length mismatch, bad "
                    "magic, or header size out of sync)",
    "FRAME-VERSION": "frame version outside the supported version "
                     "table (version skew between sender and receiver)",
    "FRAME-COVERAGE": "frame CRC32C does not cover header+payload "
                      "(a corrupted region could slip through), or "
                      "fails the Castagnoli check vector",
    # the hand kernels' budget on the card (repro_torch.analysis.smem)
    "CARD-THREADS": "a kernel instantiation's block has more threads "
                    "than the card allows a block",
    "CARD-SMEM": "a kernel instantiation's shared memory (the launch's "
                 "dynamic bytes, plus the built kernel's static bytes on "
                 "the card) exceeds the card's per-block limit, or its "
                 "__launch_bounds__ minimum of blocks needs more than a "
                 "multiprocessor holds",
    "CARD-REGS": "a built kernel's registers exceed the card's per-thread "
                 "limit, its __launch_bounds__ minimum of blocks needs "
                 "more registers than a multiprocessor has, or it cannot "
                 "launch at its block size; spilled local memory is a "
                 "warning",
    "CARD-ATTRS": "the built library's kernel attributes disagree with "
                  "the declared instantiation table (the block its "
                  "__launch_bounds__ was built for, or an instantiation "
                  "missing)",
    "CARD-RESIDENT": "a cooperative peer-push kernel cannot keep a block "
                     "of every rank on the card resident (its spin waits "
                     "would never end)",
    "CARD-PEERMEM": "the peer worlds' receive rows and signal pads of "
                    "the ranks sharing one card exceed its memory",
    "CARD-CODEC": "a launch breaks the CUDA codec's contract (group "
                  "outside KERNEL_GROUPS, theta outside [2, 20], a "
                  "framed config at the kernel, or more items than the "
                  "decode's 32-bit index)",
    # comm-site lint (repro_torch.analysis.sites)
    "SITE-SCHEME": "a site's collective scheme is incompatible with the "
                   "site shape (e.g. hierarchical at the single-hop "
                   "A2A dispatch)",
    "SITE-RESOLVE": "policy resolution fails for a (site, layer) the "
                    "model addresses",
    "SITE-SEGMENT": "scan segmentation broke its invariant (uniform "
                    "policy must yield exactly one segment)",
    "SITE-EF": "grad_ef requested but neither the grad site nor the "
               "qgrad_rs site resolves compressed — the EF residuals "
               "would never be consumed",
    "SITE-QGRAD-ALIGN": "a parameter's per-rank gradient shard is not "
                        "group-aligned for the qgrad_rs reduce-scatter "
                        "(chunks get padded; the old silent exact "
                        "fallback hid exactly this)",
    "SITE-FUSED-MESH": "fused scheme requested on a mesh/payload the "
                       "peer-push kernels (fc_ar, fc_a2a) do not serve: "
                       "an axis above MAX_PEERS, a config with no "
                       "instantiation, or peer worlds the card cannot "
                       "hold",
    "SITE-TRACE": "jaxpr trace found comm sites not resolved through "
                  "the policy engine (or expected sites missing)",
}

ERROR = "error"
WARNING = "warning"


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One analyzer finding: a rule id, severity, and human message.

    ``subject`` names what was checked ("allreduce_scatter_reduce tp=4",
    "site=a2a layer=3", ...) so multi-config sweeps stay readable.
    """
    rule: str
    severity: str
    message: str
    subject: str = ""

    def __post_init__(self):
        assert self.rule in RULES, f"unregistered rule {self.rule!r}"
        assert self.severity in (ERROR, WARNING), self.severity

    def format(self) -> str:
        tag = "error" if self.severity == ERROR else "warn "
        subj = f" [{self.subject}]" if self.subject else ""
        return f"{tag} {self.rule}{subj}: {self.message}"


def err(rule: str, message: str, subject: str = "") -> Diagnostic:
    return Diagnostic(rule, ERROR, message, subject)


def warn(rule: str, message: str, subject: str = "") -> Diagnostic:
    return Diagnostic(rule, WARNING, message, subject)


@dataclasses.dataclass
class CheckReport:
    """Accumulated diagnostics of one analyzer run."""
    diags: List[Diagnostic] = dataclasses.field(default_factory=list)
    checked: int = 0     # how many subjects were examined (for the log)

    def extend(self, diags: Iterable[Diagnostic], checked: int = 1
               ) -> "CheckReport":
        self.diags.extend(diags)
        self.checked += checked
        return self

    @property
    def errors(self) -> Tuple[Diagnostic, ...]:
        return tuple(d for d in self.diags if d.severity == ERROR)

    @property
    def warnings(self) -> Tuple[Diagnostic, ...]:
        return tuple(d for d in self.diags if d.severity == WARNING)

    @property
    def ok(self) -> bool:
        return not self.errors

    def rules_fired(self) -> Tuple[str, ...]:
        return tuple(sorted({d.rule for d in self.diags}))

    def format(self, header: str = "",
               max_warnings: int | None = None) -> str:
        lines = []
        if header:
            lines.append(header)
        lines.extend(d.format() for d in self.errors)
        warns = self.warnings
        shown = warns if max_warnings is None else warns[:max_warnings]
        lines.extend(d.format() for d in shown)
        if len(shown) < len(warns):
            lines.append(f"... {len(warns) - len(shown)} more warnings "
                         f"(per rule: " + ", ".join(
                             f"{r}={sum(1 for d in warns if d.rule == r)}"
                             for r in sorted({d.rule for d in warns}))
                         + ")")
        lines.append(f"{'PASS' if self.ok else 'FAIL'}: "
                     f"{self.checked} subjects, "
                     f"{len(self.errors)} errors, "
                     f"{len(self.warnings)} warnings")
        return "\n".join(lines)


class CommCheckError(RuntimeError):
    """Raised by the launch-time fail-fast paths; carries the report."""

    def __init__(self, report: CheckReport, context: str = ""):
        self.report = report
        head = f"commcheck failed{': ' + context if context else ''}"
        super().__init__(head + "\n" + report.format())
