"""Strict scoring of rendered frames against ground truth."""
