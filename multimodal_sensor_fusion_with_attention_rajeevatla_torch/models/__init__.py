"""Encoders, cross-modal attention, fusion heads and the flagship model."""
