"""What every decoder family shares for KV-cached beam decoding: the beam
cache's layout (the folded prefix in slots ``[0, P)``, then K time-major
slots a position, :func:`beam_slot`; the beam reorder is an ancestry mask,
:func:`beam_mask`, so the cache never moves; a recurrent state instead
moves by parent, :func:`beam_parent`), the caches of that layout
(:func:`slot_cache`, and :class:`HybridCache` for families that mix
attention with recurrent layers), a step's preamble (:func:`beam_step`)
and segment runner (CUDA graphs on the card, :func:`decode_step_graphs`),
a prefill's attention."""
from __future__ import annotations

import collections
import contextlib
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from clipcap_tpu_torch.ops.layers import round_up
from clipcap_tpu_torch.utils.profiling import ONCE, annotate

Tensor = torch.Tensor

NEG_INF = -1e9  # finite mask value: keeps softmax well-defined in bf16

# Slot counts are padded to this quantum so the cache holds the same slot
# count as the JAX package's, and the masks of the two line up slot for
# slot.  Slots past the logical capacity are never written and never read.
CACHE_SLOT_QUANTUM = 16


def softmax_attend(q: Tensor, k: Tensor, v: Tensor, bias: Optional[Tensor],
                   scale: float) -> Tensor:
    """softmax(q·kᵀ·scale + bias)·v over the last two dims: fp32 logits and
    softmax, weights cast back to q's dtype (the JAX package's XLA path)."""
    logits = (torch.matmul(q, k.transpose(-1, -2)) * scale).float()
    if bias is not None:
        logits = logits + bias
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.matmul(w, v)


def causal_bias(S: int, T: int, offset: int = 0, device="cpu") -> Tensor:
    """Additive causal bias [1, 1, S, T]: query i may attend key j iff
    j <= offset + i."""
    q_pos = torch.arange(S, device=device)[:, None] + offset
    k_pos = torch.arange(T, device=device)[None, :]
    bias = torch.where(k_pos <= q_pos, 0.0, NEG_INF).to(torch.float32)
    return bias[None, None]


def beam_slot(t, beam_size: int, cache_base: int = 0, shared: bool = False):
    """The slot of position ``t`` (int or tensor) of beam row 0, beam row
    kb's kb past it: ``P + (t - P)·K`` after the folded prefix's ``[0, P)``
    (``cache_base`` P), or ``(t - P)·K`` where the prefix is ``shared``."""
    live = (t - cache_base if cache_base else t) * beam_size
    return live if shared or not cache_base else cache_base + live


def beam_mask(ancestry: Tensor, beam_size: int, slots: int, offset: int,
              cache_base: int = 0, shared_len: Union[int, Tensor, None] = None) -> Tensor:
    """The per-step beam selection mask ``[R, K, slots]`` fp32: 0 where slot
    ``beam_slot(t) + j`` holds beam k's K/V for a position t ≤ ``offset``
    (``ancestry[b, t - cache_base] == j``) or lies in the folded prefix
    ``[0, cache_base)``; NEG_INF elsewhere.

    With ``shared_len`` c (an int or a per-sample ``[R]`` tensor) the prefix
    and the positions below c live in the shared cache: the live region
    starts at slot 0 and hides every position below c."""
    K = beam_size
    B, Tl = ancestry.shape
    R = B // K
    fold = beam_slot(cache_base, K, cache_base, shared_len is not None)   # first live slot
    anc = ancestry.reshape(R, K, Tl).repeat_interleave(K, dim=-1)
    anc = torch.nn.functional.pad(anc, (fold, slots - fold - K * Tl), value=-1)
    s_iota = torch.arange(slots, device=ancestry.device)
    s_rel = (s_iota - fold).clamp_min(0)                    # live-region slot
    pos = cache_base + s_rel // K                           # its position: beam_slot's inverse
    visible = (anc == s_rel % K) & (pos <= offset)
    if fold:
        visible = visible | (s_iota < fold)
    if shared_len is not None:
        c = torch.as_tensor(shared_len, device=ancestry.device).reshape(-1, 1, 1)
        visible = visible & (pos >= c)
    return torch.where(visible, 0.0, NEG_INF).to(torch.float32)


def slot_cache(batch: int, max_len: int, width: int, dtype=torch.bfloat16,
               beam_size: Optional[int] = None, prefix_slots: int = 0,
               device="cpu") -> Tensor:
    """A zeroed attention layer's cache ``[rows, slots, width]`` (a latent
    row, or K | V).  Plain: rows = ``batch``, slot t = position t.  With
    ``beam_size`` K: rows = ``batch // K`` in the beam layout, the folded
    prefix in slots ``[0, prefix_slots)``."""
    if beam_size is None:
        rows, slots = batch, round_up(max_len, CACHE_SLOT_QUANTUM)
    else:
        rows = batch // beam_size
        slots = round_up(prefix_slots + beam_size * max_len, CACHE_SLOT_QUANTUM)
    return torch.zeros(rows, slots, width, dtype=dtype, device=device)


@dataclasses.dataclass
class HybridCache:
    """The beam cache of a family that mixes attention with recurrent
    layers.  Per layer: ``attn`` an attention layer's slot cache (latent
    rows for Kimi-Linear's MLA, K | V for Granite's GQA; None for a
    recurrent layer), whose slots never move; ``state`` a recurrent
    layer's two state buffers and ``conv`` its two convolution windows
    (None for an attention layer): the step at position t reads buffer
    t % 2 of each row's parent (:func:`beam_parent`) and writes buffer
    (t + 1) % 2 of the row."""
    attn: List[Optional[Tensor]]
    state: List[Optional[Tuple[Tensor, Tensor]]]
    conv: List[Optional[Tuple[Tensor, Tensor]]]

    @property
    def slots(self) -> int:
        return next(c for c in self.attn if c is not None).shape[1]


def init_hybrid_cache(layers: int, recurrent: Sequence[int], slot_width: int,
                      state_shape: tuple, state_dtype: torch.dtype, window_shape: tuple,
                      batch: int, max_len: int, dtype=torch.bfloat16,
                      beam_size: Optional[int] = None, prefix_slots: int = 0,
                      device="cpu") -> HybridCache:
    """A :class:`HybridCache` for ``batch`` rows of a model of ``layers``
    layers: :func:`slot_cache` of ``slot_width`` for each layer not in
    ``recurrent``; for each one in it two state buffers ``[batch,
    *state_shape]`` in ``state_dtype`` and two windows ``[batch,
    *window_shape]`` in ``dtype``, uninitialised (a sequence's first step
    reads none)."""
    def pair(shape, dt):
        return tuple(torch.empty(batch, *shape, dtype=dt, device=device) for _ in range(2))

    rec = set(recurrent)
    return HybridCache(
        [None if i in rec else slot_cache(batch, max_len, slot_width, dtype, beam_size,
                                          prefix_slots, device) for i in range(layers)],
        [pair(state_shape, state_dtype) if i in rec else None for i in range(layers)],
        [pair(window_shape, dtype) if i in rec else None for i in range(layers)])


def folded_cache_only(bp, tile_major: bool) -> Optional[str]:
    """The first beam-cache form ``bp`` asks for beyond the folded-prefix
    bf16/fp32 cache (the only one the latent and hybrid caches have), or
    None."""
    for bad, what in ((bp.int8_kv, "int8_kv"), (bp.consolidate_every > 0, "consolidate_every > 0"),
                      (tile_major, "tile_major"), (not bp.fold_prefix, "fold_prefix=False")):
        if bad:
            return what
    return None


def beam_parent(ancestry: Tensor, beam_size: int, cache_index: int, cache_base: int) -> Tensor:
    """Each row's parent row ``[B]`` int32 for the step at position
    ``cache_index``: the row whose state after position ``cache_index − 1``
    the row's beam continues, ``ancestry[b, cache_index − 1 − cache_base]``
    within the row's sample; at the first step (``cache_index ==
    cache_base``) the sample's own row ``b // K``, where the folded prefill
    left its state.

    Slots never move: attention reads a beam's past through
    :func:`beam_mask`.  A recurrent state summarises the whole past in one
    row, so it cannot be masked; it moves by parent, each step reading its
    parent's row and writing its own."""
    B = ancestry.shape[0]
    sample = torch.arange(B, device=ancestry.device) // beam_size
    if cache_index == cache_base:
        return sample.to(torch.int32)
    return (sample * beam_size + ancestry[:, cache_index - 1 - cache_base]).to(torch.int32)


@contextlib.contextmanager
def beam_step(span: str, x: Tensor, ancestry: Tensor, beam_size: Optional[int], slots: int,
              cache_index: int, cache_base: int, graphs, shared_len=None):
    """A family's beam decode step on ``x`` [B, 1, D] → its :func:`beam_mask`,
    the :func:`beam_slot` its K rows go to and its segments' runner (``graphs``
    or :class:`EagerSteps`), in ``span`` and, with graphs, on ``x``'s device."""
    if beam_size is None or x.shape[1] != 1:
        raise ValueError("ancestry needs beam_size and one token per step")
    mask = beam_mask(ancestry, beam_size, slots, cache_index, cache_base, shared_len)
    on_card = contextlib.nullcontext() if graphs is None else torch.cuda.device(x.device)
    with annotate(span), on_card:
        yield (mask, beam_slot(cache_index, beam_size, cache_base, shared_len is not None),
               EagerSteps() if graphs is None else graphs)


class EagerSteps:
    """:class:`StepGraphs`' interface with the segments run eagerly (off
    the card, or with graphs turned off)."""

    def __init__(self):
        self.carry = None

    def run(self, segment, i: int, *inputs: Tensor) -> tuple:
        """Segment ``i`` on ``inputs`` after the previous segment's outputs."""
        self.carry = segment(i, self.carry if i else None, *inputs)
        return self.carry


class StepGraphs:
    """The dense segments of a beam decode step as CUDA graphs, for one key
    (rows, beam size, dtype, device) of one model.

    ``segment(i, carry, *inputs)`` computes segment ``i`` from ``carry``,
    the previous segment's outputs (None for segment 0), and its own
    inputs: the step's inputs for segment 0, else what ran eagerly since
    the previous segment (GPT-2: the layer's attention output).  The first
    step captures the segments in replay order into one memory pool, each
    after a warm-up run on the capture stream, and replays each right after
    its capture; later steps replay them.  :meth:`run` copies the inputs
    into static buffers, one per (segment 0 or not, argument, shape,
    dtype): the segments after the first share them, as they run one after
    the other.  A segment's outputs stay valid until the next segment of
    the pool replays, so one decode step runs at a time per key.  A capture
    cut short is taken again from segment 0."""

    def __init__(self, segments: int):
        self.segments = segments
        self.graphs: List[torch.cuda.CUDAGraph] = []
        self.outs: List[tuple] = []
        self.inputs: Dict[tuple, Tensor] = {}
        self.pool = self.stream = None

    @property
    def ready(self) -> bool:
        """Whether every segment is captured (a step replays only)."""
        return len(self.graphs) == self.segments

    def run(self, segment, i: int, *inputs: Tensor) -> tuple:
        """Segment ``i`` on ``inputs`` → its static outputs."""
        if i == 0 and not self.ready:
            self.graphs, self.outs = [], []
        static = []
        for n, t in enumerate(inputs):
            key = (i == 0, n, t.shape, t.dtype)
            buf = self.inputs.get(key)
            if buf is None:
                buf = self.inputs[key] = torch.empty_like(t)
            buf.copy_(t)
            static.append(buf)
        carry = self.outs[i - 1] if i else None
        if i < len(self.graphs):
            self.graphs[i].replay()
        else:
            self._capture(lambda: segment(i, carry, *static))
        return self.outs[i]

    def _capture(self, fn) -> None:
        """Capture one segment: its seconds go to ``ONCE`` as
        ``graphs.capture``, whose count is the segments captured."""
        with ONCE.section("graphs.capture"):
            main = torch.cuda.current_stream()
            if self.stream is None:
                self.stream = torch.cuda.Stream()
                self.pool = torch.cuda.graph_pool_handle()
            self.stream.wait_stream(main)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.stream(self.stream):
                fn()                                        # warm-up on the capture stream
                graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")
                try:
                    out = fn()
                finally:
                    graph.capture_end()
            main.wait_stream(self.stream)
            graph.replay()
        self.graphs.append(graph)
        self.outs.append(out)


class DecodeGraphs:
    """A model's :class:`StepGraphs`, one per key, the :attr:`KEEP` most
    recently used.  A graph reads each weight at the address it had at
    capture, so all keys were captured over the same weight storage: when
    any tensor the segments read (``model.decode_tensors()``: GPT-2's
    blocks and ``ln_f``) lies elsewhere than then, or has another dtype,
    shape or stride, every key is dropped and captured again.  That covers
    tensors put in place (``load_state_dict(assign=True)``) and storage
    swapped under the same parameters (``model.to(dtype)``, ``.cpu()`` then
    ``.cuda()``).  Writes into the same storage need no recapture: the
    graphs read them where they are.  A copy of the model starts with
    none."""

    KEEP = 4

    def __init__(self):
        self._weights: tuple = ()
        self._keys: "collections.OrderedDict[tuple, StepGraphs]" = collections.OrderedDict()

    def __deepcopy__(self, memo):
        return DecodeGraphs()

    def get(self, model: nn.Module, key: tuple) -> StepGraphs:
        weights = tuple((t.data_ptr(), t.device, t.dtype, t.shape, t.stride())
                        for t in model.decode_tensors())
        if weights != self._weights:
            self._weights = weights
            self._keys.clear()
        graphs = self._keys.pop(key, None) or StepGraphs(model.decode_segments)
        self._keys[key] = graphs
        while len(self._keys) > self.KEEP:
            self._keys.popitem(last=False)
        return graphs


def decode_step_graphs(model: nn.Module, rows: int, beam_size: int, dtype: torch.dtype,
                       device) -> Optional[StepGraphs]:
    """The CUDA graphs for beam decode steps of ``rows`` rows at
    ``beam_size`` in ``dtype`` on ``device`` (pass them to the family's
    forward, ``gpt2.gpt2_apply``, ``deepseek_v2.dsv2_apply``,
    ``kimi_linear.kimi_apply``, ``granite_hybrid.granite_apply`` or
    ``longcat_flash.longcat_apply``, as ``graphs``); None off a CUDA device,
    where the segments run eagerly.
    No cache form changes a segment's shapes, so every form shares a key's
    graphs."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return model.decode_graphs.get(model, (rows, beam_size, dtype, device))
