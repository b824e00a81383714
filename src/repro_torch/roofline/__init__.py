"""Roofline terms of a step counted on "meta" tensors (port of
`repro.roofline`; `repro`'s ``hlo.py`` has no counterpart: a meta run
executes every loop iteration)."""
from .analysis import (CARDS, HW, Card, StepCount, analyze_count, card_for,
                       count_step, roofline_terms)
from .breakdown import breakdown

__all__ = ["CARDS", "HW", "Card", "StepCount", "analyze_count", "breakdown",
           "card_for", "count_step", "roofline_terms"]
