"""Host-side runtime of the port (input pipeline helpers)."""
