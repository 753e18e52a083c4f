"""Serving knobs and checkpoint metadata key.

The one-shot ``InferenceEngine`` is not ported yet; the generation
engine (decode.py) and the scheduler read their knobs through here.
"""

from __future__ import annotations

from ..core.knobs import Knobs

#: checkpoint metadata key under which a serving process finds the
#: model description it rebuilds the model from
SERVING_META_KEY = "serving"


def serving_knobs() -> Knobs:
    """The serving_* knob source: a fresh parse of the environment (a
    serving process has no training world whose knobs it could share)."""
    return Knobs.from_env()
