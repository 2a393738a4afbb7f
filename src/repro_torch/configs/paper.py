"""The paper's own experimental configurations (Tables 3 & 4) as data.

``DATASETS`` mirrors Table 3 (dimensions) and §4.2 (construction);
``CONFIGS`` mirrors Table 4: the equal-bit-budget configuration grids per
technique and dataset family.  benchmarks/bench_tlb.py and friends draw
from these; keeping them here makes the reproduction surface auditable in
one place.
"""

from __future__ import annotations

# --- Table 3: dataset dimensions -------------------------------------------
DATASETS = {
    "season": dict(n=1000, lengths=[480, 960, 1440, 1920], season_len=10,
                   strengths="1-99% (+-0.5pp)"),
    "trend": dict(n=1000, lengths=[480, 960, 1440, 1920],
                  strengths="1-99% (+-0.5pp)"),
    "metering": dict(n=5958, length=21_840, season_len=48,
                     mean_daily_strength=0.183, surrogate="metering_like"),
    "economy": dict(n=6400, length=300, interval="monthly",
                    surrogate="economy_like"),
    "season_large": dict(n=[6_510_417, 13_020_833], length=960,
                         strengths=[0.10, 0.50, 0.90],
                         note="50/100 Gb efficiency sets; container-scale "
                              "surrogate uses n=20,000 (EXPERIMENTS.md)"),
}

# --- Table 4: equal-budget technique configurations -------------------------
# synthetic: 320-bit budget
SYNTH_SAX = [dict(W=32, A=1024), dict(W=40, A=256), dict(W=48, A=101),
             dict(W=96, A=10)]
SYNTH_SSAX = [dict(W=24, A_res=1024, A_seas=256),
              dict(W=48, A_res=32, A_seas=256),
              dict(W=48, A_res=64, A_seas=9)]
SYNTH_TSAX_ATR = [32, 128, 1024]     # A_res = 2**((320 - ld(A_tr)) // W)

# metering: 3640-bit budget
METERING_SAX = [dict(W=455, A=256), dict(W=520, A=128),
                dict(W=728, A=32), dict(W=910, A=16)]
METERING_SSAX_ASEAS = [16, 64, 256, 1024]   # W=455; A_res from the budget

# economy: 80-bit budget
ECONOMY_SAX = [dict(W=10, A=256), dict(W=12, A=101), dict(W=15, A=40),
               dict(W=20, A=16), dict(W=30, A=6)]
ECONOMY_1DSAX_AS = [8, 16, 32]               # A_a = 2**((80/W) - ld(A_s))
ECONOMY_TSAX_ATR = [16, 64, 256, 1024]

LOOKUP_TABLE_LIMIT_BYTES = 4 * 1024 * 1024   # paper: <= 4 Mb => A <= 1024
