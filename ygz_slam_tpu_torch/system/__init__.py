"""System facade and trajectory tools."""
