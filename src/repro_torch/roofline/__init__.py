"""Roofline terms: analytic FLOPs and bytes per step, and their bounds."""
