"""Training substrate: optimizer, loop, microbatching, compression."""
