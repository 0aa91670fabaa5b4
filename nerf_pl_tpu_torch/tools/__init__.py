"""Model loading, the chunked whole-image render and the HTTP render
server."""
