"""Splitting verification over several cards (``mesh``) and the
sharded-dispatch report (``report``)."""
