"""What a runner hands back from one run of a cell."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from harness.checks import Check
from harness.trace import Stretch


@dataclasses.dataclass
class Outcome:
    setup_s: float
    window_s: float
    rates: Dict[str, float]          # end-to-end rates by metric name
    attempted: int
    failed: int
    checks: List[Check]
    memory_peak_bytes: int
    stretch: Optional[Stretch] = None
    # what per-layer readers need besides the trace: the kind of cell
    # ('predict' or 'train'), its batch, ...
    facts: Dict = dataclasses.field(default_factory=dict)
