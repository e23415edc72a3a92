"""Speculative decoding: a draft model proposes, the teacher verifies.

The port of ``zookeeper_tpu/serving/decode/speculative.py``. Greedy
speculation emits up to ``k + 1`` tokens per teacher dispatch: a small
draft model proposes ``k`` tokens per slot, one teacher ``verify``
scores all ``k + 1`` window positions (a multi-row KV append), and the
scheduler keeps the longest prefix on which the draft matched the
teacher's argmax, plus the teacher's own token at the first mismatch.
Every emitted token is the teacher's argmax given the committed prefix,
so the output equals plain greedy decode; a rejected suffix is rolled
back by not advancing the lengths over it.

This component owns the draft half: a second :class:`DecodeEngine`
mirroring the teacher's slots, buckets and capacity in the slot layout
(its own KV cache: the draft's prefill runs K9, its decode steps K12),
named ``draft_`` in the (inert) program ledger. The two-model schedule
lives in ``DecodeScheduler._decode_spec``; the CLI surface is
``LMServingConfig.speculative``. At world size > 1 a draft raises
``ValueError`` (ROADMAP.md Queue 1 item 4); at one rank it serves under
the teacher's partitioner.
"""

import logging
from typing import Any, Optional

from zookeeper_tpu_torch.core import ComponentField, Field, component, configure
from zookeeper_tpu_torch.models.base import Model
from zookeeper_tpu_torch.models.transformer import TransformerLM
from zookeeper_tpu_torch.serving.decode.engine import DecodeEngine

logger = logging.getLogger(__name__)

__all__ = ["SpeculativeDecoding"]


@component
class SpeculativeDecoding:
    """Config and runtime binding of the draft/verify schedule. The
    Fields are ``LMServingConfig.speculative``'s CLI surface
    (``speculative.enabled=True speculative.k=4
    speculative.draft_checkpoint=DIR``); :meth:`bind` attaches a built
    draft module and the teacher engine whose geometry the draft engine
    mirrors."""

    #: Master switch: False serves plain decode.
    enabled: bool = Field(False)
    #: Draft tokens proposed per window: each window costs ``k`` draft
    #: dispatches and one teacher verify, and emits 1 to ``k + 1`` tokens.
    k: int = Field(4)
    #: The draft's geometry (built at the teacher's seq_len and vocab).
    draft_model: Model = ComponentField(TransformerLM)
    #: A ``save_model`` export or ``Checkpointer`` directory holding the
    #: draft weights; None initializes ``draft_model`` from the seed
    #: (acceptance then near chance unless it is the teacher's geometry).
    draft_checkpoint: Optional[str] = Field(None)
    #: EMA or raw weights of the draft checkpoint, as the teacher's
    #: ``weights``.
    draft_weights: str = Field("auto")

    def bind(self, engine: DecodeEngine, draft_module: Any, *,
             partitioner: Any = None) -> "SpeculativeDecoding":
        """Build and warm the draft engine over ``draft_module`` (its
        weights loaded) mirroring the teacher ``engine``'s slots, buckets
        and capacity on its device and partitioner, and run the verify
        widths once: the teacher's ``k + 1`` and the draft's width-2
        catch-up. Raises ``ValueError`` for ``k < 1``, a vocabulary that
        differs from the teacher's, a draft positional table shorter than
        the prompt buckets, or a partitioner spanning several ranks."""
        engine._require_bound()
        if int(self.k) < 1:
            raise ValueError(f"speculative.k={self.k} must be >= 1.")
        teacher_vocab = getattr(engine._module, "vocab_size", None)
        draft_vocab = getattr(draft_module, "vocab_size", None)
        if teacher_vocab is not None and draft_vocab is not None and \
                int(teacher_vocab) != int(draft_vocab):
            raise ValueError(
                f"draft vocab_size {draft_vocab} != teacher vocab_size {teacher_vocab}: "
                "the drafts would be scored in another token id space. Build the draft "
                "at the teacher's vocabulary."
            )
        partitioner = partitioner if partitioner is not None else engine._partitioner
        if partitioner.process_span() > 1:
            raise ValueError(
                f"a speculative draft engine at world size {partitioner.process_span()} is "
                "not ported (ROADMAP.md Queue 1 item 4); serve speculation on one rank."
            )
        draft = DecodeEngine()
        configure(draft, {
            "slots": int(engine.slots),
            "seq_buckets": tuple(engine._seq_buckets),
            "prefill_buckets": tuple(engine._prefill_buckets),
            "kv_capacity": int(engine.capacity),
            "page_size": int(engine.page_size),
            "decode_attention": str(engine.decode_attention),
            "ledger_prefix": "draft_",
        }, name="speculative_draft_engine")
        draft.bind(draft_module, partitioner=partitioner, device=engine.device)
        draft.warmup()
        draft.warmup_verify(2)  # the catch-up gap (<= 1) and the current token
        engine.warmup_verify(int(self.k) + 1)
        object.__setattr__(self, "_engine", engine)
        object.__setattr__(self, "_draft_engine", draft)
        object.__setattr__(self, "_proposed_total", 0)
        object.__setattr__(self, "_accepted_total", 0)
        logger.info("speculative decoding bound: k=%d, draft of %d layers, verify window %d",
                    int(self.k), int(getattr(draft_module, "num_layers", -1)),
                    int(self.k) + 1)
        return self

    def _require_bound(self) -> None:
        if getattr(self, "_draft_engine", None) is None:
            raise RuntimeError(
                "SpeculativeDecoding is not bound: call spec.bind(teacher_engine, "
                "draft_module) first."
            )

    @property
    def engine(self) -> DecodeEngine:
        """The teacher engine this binding mirrors."""
        self._require_bound()
        return self._engine

    @property
    def draft_engine(self) -> DecodeEngine:
        self._require_bound()
        return self._draft_engine

    @property
    def window(self) -> int:
        """The teacher's verify width: ``k`` drafts and the current token."""
        return int(self.k) + 1

    def record_window(self, proposed: int, accepted: int) -> None:
        """Lifetime acceptance accounting (the scheduler's commit, under
        its lock)."""
        object.__setattr__(self, "_proposed_total", self._proposed_total + int(proposed))
        object.__setattr__(self, "_accepted_total", self._accepted_total + int(accepted))

    @property
    def acceptance_rate(self) -> float:
        """Lifetime accepted-draft fraction (-1 before any window)."""
        proposed = getattr(self, "_proposed_total", 0)
        if not proposed:
            return -1.0
        return self._accepted_total / proposed

    def status(self) -> dict:
        self._require_bound()
        return {
            "enabled": True,
            "k": int(self.k),
            "acceptance_rate": round(self.acceptance_rate, 4),
            "proposed_tokens": int(self._proposed_total),
            "accepted_tokens": int(self._accepted_total),
            "draft_compiles": self._draft_engine.compile_count,
            "draft_recompiles_detected": self._draft_engine.recompiles_detected,
            "draft_decode_attention": self._draft_engine.decode_attention_flavor,
        }
