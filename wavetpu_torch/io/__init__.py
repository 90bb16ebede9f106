"""Reports and state hand-over."""
