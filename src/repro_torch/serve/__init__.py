"""Serving: the continuous-batching engine, the multi-tenant fine-tuning
service and its load generator (counterparts of ``src/repro/serve/``)."""
