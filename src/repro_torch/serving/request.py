"""Serving request objects (copy of ``repro/serving/request.py``; the port
keeps its own so that it imports nothing of the JAX package)."""

from __future__ import annotations

import dataclasses
import itertools
from typing import List, Optional

_ids = itertools.count()


@dataclasses.dataclass
class ServeRequest:
    prompt: List[int]                      # token ids (or frontend embeds id)
    max_new_tokens: int
    rid: int = dataclasses.field(default_factory=lambda: next(_ids))
    eos_id: Optional[int] = None
    arrival_s: float = 0.0
    # progress (preserved across migrations — paper §5.1)
    generated: List[int] = dataclasses.field(default_factory=list)
    migrations: int = 0
    # timestamps (virtual clock)
    first_token_s: float = -1.0
    finish_s: float = -1.0

    @property
    def ctx_len(self) -> int:
        """Current context length (prompt + generated so far)."""
        return len(self.prompt) + len(self.generated)

    @property
    def done(self) -> bool:
        if len(self.generated) >= self.max_new_tokens:
            return True
        return bool(self.generated and self.eos_id is not None
                    and self.generated[-1] == self.eos_id)

    def full_context(self) -> List[int]:
        """Prompt + already-generated output — the recomputation input for
        output-preserving migration."""
        return list(self.prompt) + list(self.generated)
