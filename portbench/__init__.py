"""The benchmark of transmf_ad_tpu_torch on NVIDIA H100 cards.

`python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of `BENCHMARK.json` once. Everything that
belongs to one configuration, traffic mix or per-layer metric is a file of
its own here, found by the name `BENCHMARK.json` gives it:
`configs/<config>.json`, `traffic/<mix>.json` (whose "kind" names the
module, `kinds/<kind>.py`), `metrics/<metric>.py` and
`limits/<cell>.json` (the correctness limits and the readings they were
set from). `reference/` is the plain float32 model (one module a
configuration's `"reference"`), `counts/` the operations and bytes from
shapes (a reference's model FLOPs in `counts/models/<reference>.py`, a
`transmf::` op's least work in `counts/kernels.py` or
`counts/ops/<op>.py`), `peaks.py` the card's published peaks.
"""
