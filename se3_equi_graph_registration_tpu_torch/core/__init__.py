"""Pose algebra of the port."""
