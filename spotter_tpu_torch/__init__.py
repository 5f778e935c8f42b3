"""PyTorch/CUDA port of spotter-tpu for NVIDIA Hopper (H100).

Sits beside the JAX package `spotter_tpu`, which stays the reference. This
package imports `torch` and never `jax`, and nothing of `spotter_tpu`: the
jax-free tables it needs (configs, COCO labels, amenity taxonomy) are kept
as copies here.

So far the port covers the default detection path: `MODEL_NAME=PekingU/rtdetr_v2_r101vd`
through host resize, on-device rescale, the RT-DETRv2 forward (ResNet-101-vd,
hybrid encoder, deformable decoder whose sampling runs a hand-written CUDA
kernel, `csrc/msda.cu`), the sigmoid top-k postprocess, thresholding and the
amenity response assembly.

Entry points take an explicit `device`. With none given they run on `cuda`,
and raise where no GPU is present; the CPU runs only when asked for
(`device="cpu"`), as the tests do.
"""
