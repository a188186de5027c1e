"""Windowed PAMAP2 data (numpy) and its device-resident form (torch)."""
