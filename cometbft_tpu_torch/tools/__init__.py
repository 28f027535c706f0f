"""Tools that drive a node: the load generator (``loadtime``), the e2e
manifests and their runner (``manifest``), the QA net (``qa``) with its
fleet analysis (``fleet_report``), the coverage-guided fuzzer (``fuzz``)
and the two-commit chip comparison (``smoke_ab``)."""
