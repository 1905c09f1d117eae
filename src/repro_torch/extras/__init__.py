"""Kernels that the JAX package keeps under ``src/repro/extras/``, each with
its ``ops.py`` entry point: `segment_mp` (GNN message aggregation, run by
``models/gnn.py`` through ``Kernels.segment_mp``), `join_probe` (the
sort-merge join's probe as two standalone kernels) and `flash_attention`
(causal GQA attention, run by the LM prefill through
``Kernels.flash_attention``)."""
