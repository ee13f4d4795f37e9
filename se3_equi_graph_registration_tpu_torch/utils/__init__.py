"""Host-side utilities of the port: timing, metrics logging, failure detection."""
