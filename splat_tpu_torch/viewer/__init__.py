"""Interactive HTTP viewer."""
