"""Config loading and device resolution."""
