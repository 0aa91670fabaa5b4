"""Model loading and the HTTP render server."""
