"""Strategies and client pools."""
