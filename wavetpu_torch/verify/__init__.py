"""Analytic-solution oracle."""
