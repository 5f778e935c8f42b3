"""Box geometry on tensors (port of spotter_tpu.ops.boxes, inference half)."""

import torch


def center_to_corners(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 4) [cx, cy, w, h] -> [xmin, ymin, xmax, ymax]."""
    cx, cy, w, h = boxes.unbind(-1)
    return torch.stack(
        [cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], dim=-1
    )


def scale_boxes(boxes: torch.Tensor, target_sizes: torch.Tensor) -> torch.Tensor:
    """Scale normalized corner boxes (B, Q, 4) to pixel coords.

    target_sizes: (B, 2) as [height, width], the reference's convention.
    """
    h = target_sizes[..., 0:1]
    w = target_sizes[..., 1:2]
    scale = torch.stack([w, h, w, h], dim=-1).reshape(*target_sizes.shape[:-1], 1, 4)
    return boxes * scale
