"""PyTorch/CUDA port of spotter-tpu for NVIDIA Hopper (H100).

Sits beside the JAX package `spotter_tpu`, which stays the reference. This
package imports `torch` and never `jax`, and nothing of `spotter_tpu`: the
jax-free code it needs (configs, COCO labels, amenity taxonomy, the wire
schemas, the serving layer's resilience, overload and scheduling modules) is
kept as copies here.

So far the port covers the default detection path, from the replica's HTTP
`POST /detect` (`serving/standalone.py`) through fetch, decode, the
micro-batcher and the engine to the RT-DETRv2 forward
(`MODEL_NAME=PekingU/rtdetr_v2_r101vd`: ResNet-101-vd, hybrid encoder,
deformable decoder whose MSDA sampling runs hand-written CUDA kernels,
`csrc/msda.cu`, one per `SPOTTER_TPU_MSDA_PREP` setting), the sigmoid top-k
postprocess, thresholding, the drawn labeled image and the amenity response.
The same path serves YOLOS (`MODEL_NAME=hustvl/yolos-base`: a ViT whose
4301-token self-attention runs the hand-written flash-attention kernel,
`csrc/attention.cu`, in fp32 or, under the mixed and bfloat16 policies,
bf16) with the softmax postprocess.

Entry points take an explicit `device`. With none given they run on `cuda`,
and raise where no GPU is present; the CPU runs only when asked for
(`device="cpu"`), as the tests do.
"""
