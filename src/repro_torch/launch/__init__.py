"""Serving launchers of the port."""
