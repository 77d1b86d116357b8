"""Probability/odds numerics for occupancy grids.

Reference: cartographer/mapping/probability_values.h:32-143. The reference
stores cell occupancy as uint16 in [1, 32767] with 32768-entry lookup tables
applying a fixed odds multiplication per hit/miss, probabilities clamped to
[0.1, 0.9], and a `kUpdateMarker` bit guaranteeing one update per cell per
scan.

TPU-native representation: **float32 log-odds** per cell plus a known-cell
bit. The odds multiplication becomes a clipped addition
    L' = clip(L + log(odds_update), L_min, L_max)
which is exactly the reference's update in continuous form (the reference
additionally quantizes through uint16; we keep float32 — the quantization
step of the reference is 0.8/32766 ~ 2.4e-5 in probability, far below any
physical signal). The once-per-scan semantics are enforced structurally: an
insert computes per-scan hit/miss masks and applies exactly one update per
cell (hits take priority over misses, matching
probability_grid_range_data_inserter_2d.cc:52-96).

Unknown cells score as kMinProbability (0.1) for matching, and are treated
as p=0.5 priors on their first update (probability_values.h
ComputeLookupTableToApplyOdds).
"""

from __future__ import annotations

import math

import numpy as np

MIN_PROBABILITY = 0.1
MAX_PROBABILITY = 1.0 - MIN_PROBABILITY
MIN_CORRESPONDENCE_COST = 1.0 - MAX_PROBABILITY
MAX_CORRESPONDENCE_COST = 1.0 - MIN_PROBABILITY

# log-odds bounds implied by the probability clamp.
MIN_LOG_ODDS = math.log(MIN_PROBABILITY / (1.0 - MIN_PROBABILITY))  # log(1/9)
MAX_LOG_ODDS = math.log(MAX_PROBABILITY / (1.0 - MAX_PROBABILITY))  # log(9)


def odds(probability):
    return probability / (1.0 - probability)


def probability_from_odds(o):
    return o / (o + 1.0)


def probability_to_correspondence_cost(probability):
    return 1.0 - probability


def correspondence_cost_to_probability(cost):
    return 1.0 - cost


def clamp_probability(p, xp=np):
    return xp.clip(p, MIN_PROBABILITY, MAX_PROBABILITY)


def log_odds(probability, xp=np):
    return xp.log(probability) - xp.log1p(-probability)


def probability_from_log_odds(l, xp=np):
    # sigmoid
    return 1.0 / (1.0 + xp.exp(-l))


def apply_odds_update(l, update_log_odds, xp=np):
    """One hit/miss update on log-odds cells (reference ApplyLookupTable)."""
    return xp.clip(l + update_log_odds, MIN_LOG_ODDS, MAX_LOG_ODDS)


def hit_update_log_odds(hit_probability: float) -> float:
    """log odds delta applied on a hit (hit_probability > 0.5)."""
    assert hit_probability > 0.5
    return math.log(odds(hit_probability))


def miss_update_log_odds(miss_probability: float) -> float:
    assert miss_probability < 0.5
    return math.log(odds(miss_probability))
