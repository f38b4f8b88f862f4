"""The roofline of a dry-run step.

* :mod:`repro_torch.roofline.analysis` — the analytic bytes, the useful
  FLOPs and the compute / memory / collective terms on the H100;
* :mod:`repro_torch.roofline.report` — the table, from the dry run's
  records.

The operation counter the dry run traces under is
:mod:`repro_torch.core.opcount`.
"""
from repro_torch.roofline.analysis import (HBM_BW, LINK_BW, PEAK_FLOPS,
                                           Roofline, analytic_bytes, analyze,
                                           model_flops)

__all__ = ["HBM_BW", "LINK_BW", "PEAK_FLOPS", "Roofline", "analytic_bytes",
           "analyze", "model_flops"]
