"""Energy voice activity detection."""
