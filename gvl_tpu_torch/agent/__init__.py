"""Chat backend of the reasoning core."""
