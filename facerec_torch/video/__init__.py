"""Host-side video ingest: probing, DAR correction, block decoding, and
synthetic clips."""
