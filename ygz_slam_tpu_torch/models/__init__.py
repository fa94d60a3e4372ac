"""The assembled tracking step."""
