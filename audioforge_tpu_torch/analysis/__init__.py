"""Offline analysis helpers."""
