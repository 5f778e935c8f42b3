"""Per-bucket CUDA graphs: the port's counterpart of the JAX engine's one
compiled program per bucket (spotter_tpu/engine/engine.py's jit cache).

A forward of RT-DETR at B = 8 issues ~1,600 launches, and under the bf16
policies the host takes longer to issue them than the card to run them.
`capture` records one forward into a `torch.cuda.CUDAGraph`; a replay then
issues the whole forward as one graph launch. The engine keys graphs by
`graph_key`: the shape key the JAX engine compiles by, plus every knob the
port reads while a forward runs (`forward_knobs`), so a knob change gives
a new capture and never a stale replay.

Capture rules the forward keeps: nothing in it syncs the host (`.item()`,
`.cpu()`, data-dependent shapes), every per-shape table is cached (and
never evicted) on the first (eager) forward of that shape, and every hand-written kernel
launches on `torch.cuda.current_stream()`, which under capture is the
capturing stream. An eager forward of the same key therefore always runs
right before its capture, in the same thread: it warms the allocator, sets
each kernel's one-time attributes, builds the shape tables, fills the int8
path's kept codes and builds cuDNN's and cuBLAS's plans (kept per thread),
so the capture allocates nothing outside the graph's pool and the graph
reads the same storage on every replay.

Launch counts: each kernel wrapper adds one to its `launches` where it
launches, and `utils/quant.py`'s `CALLS` counts quantized products. Under
capture nothing launches, so `capture` puts every count back as it was and
keeps the difference, which `ForwardGraph.replay` adds on every replay:
the counts then say what the served forwards ran, replays included. The
engine's FLOPs-counting forward is not a served forward, and its launches
are put back too (`uncounted`).

There is no switch that turns graphs off and no fallback to eager when a
capture fails: a failed capture raises. The CPU path never captures.
"""

import os
import time
from contextlib import contextmanager
from typing import Callable, Optional, Sequence

import torch

from spotter_tpu_torch.models.layers import kept_values

# the knobs read while a forward runs (the module attributes the ops and
# models read, and the environment variables they read at the call)
KNOB_ENVS = ("SPOTTER_TPU_DTYPE", "SPOTTER_TPU_REP_FUSE", "SPOTTER_TPU_TOPK")


def kernel_wrappers() -> dict:
    """Every hand-written kernel wrapper a forward can reach, by name."""
    from spotter_tpu_torch.ops import attention, int8, msda, openvocab

    return {
        "msda_gather_sum": msda.msda_gather_sum, "msda_loc_sum": msda.msda_loc_sum,
        "msda_fused_sum": msda.msda_fused_sum, "msda_sep_sum": msda.msda_sep_sum,
        "msda_hd_gather_sum": msda.msda_hd_gather_sum,
        "split_kv_tf32": attention.split_kv_tf32,
        "flash_attn_fp32": attention.flash_attn_fp32,
        "flash_attn_bf16": attention.flash_attn_bf16,
        "owl_class_logits": openvocab.owl_class_logits,
        "amax_s8": int8.amax_s8, "quantize_s8": int8.quantize_s8,
        "transpose_s8": int8.transpose_s8, "int8_gemm": int8.int8_gemm,
        "int8_gemm_kmajor": int8.int8_gemm_kmajor, "dequant_s32": int8.dequant_s32,
    }


def read_counts() -> dict:
    """Every launch count and quantized-call count, by name."""
    from spotter_tpu_torch.utils import quant

    counts = {name: fn.launches for name, fn in kernel_wrappers().items()}
    counts.update({f"quant.{name}": n for name, n in quant.CALLS.items()})
    return counts


def add_counts(delta: dict) -> None:
    """Add `delta` (a `read_counts` difference) to the live counts."""
    from spotter_tpu_torch.utils import quant

    wrappers = kernel_wrappers()
    for name, n in delta.items():
        if name.startswith("quant."):
            quant.CALLS[name[len("quant."):]] += n
        else:
            wrappers[name].launches += n


@contextmanager
def uncounted():
    """Put every count back as it was when the block ends: for work that is
    not a served forward (a capture, which launches nothing, and the
    engine's FLOPs-counting forward)."""
    before = read_counts()
    try:
        yield
    finally:
        after = read_counts()
        add_counts({k: before[k] - after[k] for k in before})


def forward_knobs() -> tuple:
    """The values of the knobs the port reads while a forward runs: the
    MSDA backend, prep and precision (module attributes, which chip_smoke
    and tests set, and their resolved precision), the int8 switches and
    floors, the attention, GELU and class-logit choices, and the
    environment variables read at the call (the dtype policy, RepVGG
    fusion, the top-k selector)."""
    from spotter_tpu_torch.models import layers
    from spotter_tpu_torch.ops import msda, openvocab
    from spotter_tpu_torch.utils import quant

    return (
        ("msda", msda.MSDA_BACKEND), ("msda_prep", msda.MSDA_PREP),
        ("msda_precision", msda.MSDA_PRECISION, msda.msda_precision()),
        ("int8", quant.INT8, quant.INT8_DENSE, quant.INT8_ATTN, quant.INT8_MIN_CH,
         quant.INT8_MIN_BATCH, quant.INT8_ATTN_MIN_HD),
        ("flash", layers.FLASH_ATTN_ENABLED, layers.FLASH_IMPL, layers.GELU_MODE),
        ("owl_fused", openvocab.OWL_FUSED),
        *((env, os.environ.get(env)) for env in KNOB_ENVS),
    )


def graph_key(shape_key: str) -> tuple:
    """What a captured forward is valid for: its shape key and the knobs."""
    return (shape_key, forward_knobs())


class ForwardGraph:
    """One captured forward: its static inputs and outputs, the graph, and
    the counts one run adds."""

    def __init__(self, graph, inputs: tuple, outputs: tuple, counts: dict,
                 capture_s: float, held: list) -> None:
        self.graph = graph
        self.inputs = inputs
        self.outputs = outputs
        self.counts = counts
        self.capture_s = capture_s
        self.held = held  # the kept values the graph reads in place
        self.replays = 0

    def replay(self, inputs: Sequence[Optional[torch.Tensor]]) -> tuple:
        """Copy `inputs` into the static inputs (on the current stream, so
        ordered after the previous replay's reads and copies), replay, and
        add the captured counts. Returns the static outputs: the caller
        copies them out before the next replay of any graph of the engine
        (graphs share one memory pool)."""
        for static, new in zip(self.inputs, inputs):
            if static is not None:
                static.copy_(new, non_blocking=True)
        self.graph.replay()
        add_counts(self.counts)
        self.replays += 1
        return self.outputs


def capture(fn: Callable, inputs: Sequence[Optional[torch.Tensor]], pool,
            stream: torch.cuda.Stream, module: torch.nn.Module) -> ForwardGraph:
    """Capture `fn(*inputs)` on `stream` into a graph drawing on `pool`.

    Static inputs are fresh copies of `inputs`, allocated outside the pool.
    The graph holds every value `module` keeps (`models/layers.py` `kept`)
    at capture, so a newer kept value never frees storage it reads.
    The capture's error mode is thread-local, so another thread's event
    wait (an earlier chunk's D2H) does not invalidate it. A failed capture
    raises; the counts are put back either way."""
    with torch.cuda.stream(stream):
        static = tuple(None if t is None else t.clone() for t in inputs)
    before = read_counts()
    graph = torch.cuda.CUDAGraph()
    t0 = time.monotonic()
    stream.synchronize()
    with uncounted():
        # capture_begin/end rather than `torch.cuda.graph`, which also runs
        # the garbage collector and empties the allocator's cache each time
        with torch.cuda.stream(stream):
            graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                outputs = tuple(fn(*static))
            finally:
                graph.capture_end()
        stream.synchronize()
        after = read_counts()
    counts = {k: after[k] - before[k] for k in before if after[k] != before[k]}
    return ForwardGraph(graph, static, outputs, counts, time.monotonic() - t0,
                        kept_values(module))
