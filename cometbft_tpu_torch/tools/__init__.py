"""Tools that drive a node: the load generator (``loadtime``), the e2e
manifests and their runner (``manifest``), the QA net (``qa``) with its
fleet analysis (``fleet_report``), the coverage-guided fuzzer (``fuzz``),
the BASELINE configs' runner (``benchmarks``) and the two-commit chip
comparison (``smoke_ab``); and the tools that read a node's records: the
per-height trace report (``trace_report``), the fleet report's text and
CLI (``fleet_report``) and the metrics catalog (``metrics_catalog``)."""
