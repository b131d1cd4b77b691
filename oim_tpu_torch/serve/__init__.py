"""The continuous-batching engine over the paged KV pool and its HTTP
server."""
