"""Host-side request handling."""
