"""Host orchestration: paths, manifests, ingest, scheduling, cluster."""
