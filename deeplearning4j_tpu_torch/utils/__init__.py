"""Helpers of the port."""
