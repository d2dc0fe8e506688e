"""The serving stack's documented result/telemetry dictionary keys.

A copy of ``repro.serving.result_keys``: the port keeps its own so it
imports nothing of the reference package, and the port's tests hold the
two copies equal.

Every stringly-typed key that crosses a serving API boundary lives here,
once:

* **info keys** — what :attr:`SampleResult.info` (and therefore
  ``SamplerService.sample(...).info``) carries alongside ``x0``;
* **aux keys** — the solver diagnostics merged into ``info`` (produced by
  the solver programs in ``core/``, scoped per request by the executor);
* **stats keys** — ``AsyncBatchedSampler.stats()`` counters.

serving/ and benchmarks/ must reference these constants instead of
re-typing the literals — ``tests/test_result_keys.py`` greps both trees
and fails on any stringly-typed duplicate, so a renamed key can never
silently fork into two spellings.  The wire schema
(``serving/frontdoor.py``) serializes ``SampleResult`` field-by-field, so
these keys are also exactly what a front-door client sees in a response's
``aux``/``info``.
"""

from __future__ import annotations

# ---- SampleResult.info keys (facade info dict / wire response) ----------
#: wall time of the fused batch the request rode in (shared by batch-mates)
WALL_S = "wall_s"
#: submit -> result wall time for this request alone
LATENCY_S = "latency_s"
#: batch size the compiled program ran at (batch bucket, or exact size)
PADDED_BATCH = "padded_batch"
#: sequence length the compiled program ran at (seq bucket under seq
#: bucketing, exact ``seq_len`` otherwise)
PADDED_SEQ_LEN = "padded_seq_len"
#: NFE budget the compiled program scanned to (NFE bucket under nfe
#: bucketing, exact ``nfe`` otherwise) — the request's own steps beyond its
#: exact NFE are inert pad steps under the per-row step mask
PADDED_NFE = "padded_nfe"

#: the engine-telemetry keys every ``SampleResult.info`` carries, in order
INFO_KEYS = (WALL_S, LATENCY_S, PADDED_BATCH, PADDED_SEQ_LEN, PADDED_NFE)

# ---- solver-diagnostic aux keys (merged into info, scoped per request) --
#: per-step ERS error measure (batch mean under per-sample ERS), shape (nfe,)
DELTA_EPS_HISTORY = "delta_eps_history"
#: per-step, per-row ERS error measure under per-sample ERS, shape (nfe, B)
DELTA_EPS_HISTORY_PER_SAMPLE = "delta_eps_history_per_sample"
#: per-step Lagrange basis selections under per-sample ERS, shape (nfe, B, k)
ERS_SELECTION_HISTORY = "ers_selection_history"
#: full latent trajectory when ``return_trajectory`` is set
TRAJECTORY = "trajectory"
#: per-row model evaluations actually spent by the adaptive DPM-Solver
#: (accept + reject), shape (B,) int32 — contrast with the nfe *budget*
REALIZED_NFE = "realized_nfe"

#: the documented solver-diagnostic keys, in order
AUX_KEYS = (
    DELTA_EPS_HISTORY,
    DELTA_EPS_HISTORY_PER_SAMPLE,
    ERS_SELECTION_HISTORY,
    TRAJECTORY,
    REALIZED_NFE,
)

# ---- AsyncBatchedSampler.stats() keys -----------------------------------
#: total requests accepted by submit()
SUBMITTED = "submitted"
#: fused batches launched
BATCHES = "batches"
#: rows executed across all launched batches
ROWS = "rows"
#: mean rows per fused batch (fuse efficiency)
MEAN_BATCH_ROWS = "mean_batch_rows"

STATS_KEYS = (SUBMITTED, BATCHES, ROWS, MEAN_BATCH_ROWS)
