"""HTTP serving: batching engines and the summarization server."""
