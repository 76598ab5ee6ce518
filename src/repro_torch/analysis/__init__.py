"""Static comm-safety analysis (commcheck), the port's copy of the JAX
package's ``analysis/``.

Three layers over one substrate:

* :mod:`repro_torch.analysis.choreography` — N-rank happens-before
  analysis of the declared peer-push protocols
  (:mod:`repro_torch.kernels.protocol`);
* :mod:`repro_torch.analysis.layout` / :mod:`repro_torch.analysis.smem` —
  wire buffer partition proofs and the hand kernels' budget on the card
  (threads, shared memory, registers, residency, peer-world memory: the
  counterpart of the JAX package's VMEM budget);
* :mod:`repro_torch.analysis.frames` — self-describing frame conformance
  (header/layout agreement, version table, checksum coverage);
* :mod:`repro_torch.analysis.sites` — the comm-site lint against the
  policy engine, static enumeration + one recorded train step.

:mod:`repro_torch.analysis.commcheck` is the CLI and the launch-time
entry points (``launch_report`` / ``check_fused_request``);
:mod:`repro_torch.analysis.mutations` holds the self-test fixtures.
"""
from repro_torch.analysis.report import (CheckReport,  # noqa: F401
                                         CommCheckError, Diagnostic, RULES)
