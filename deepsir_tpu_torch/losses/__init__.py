"""Training losses (deepsir_tpu/losses), exported as its __init__ does."""
from deepsir_tpu_torch.losses.align import scan_alignment_loss, correspondence_correct  # noqa: F401
from deepsir_tpu_torch.losses.detdes import det_des_loss, circle_loss  # noqa: F401
from deepsir_tpu_torch.losses.semantic import (  # noqa: F401
    semantic_loss, confusion_matrix, SemanticMetric,
)
from deepsir_tpu_torch.losses.chamfer import chamfer_loss, single_side_chamfer  # noqa: F401
