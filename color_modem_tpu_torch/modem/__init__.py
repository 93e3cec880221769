"""Modem layer: the plans and the plain QAM and SECAM modem functions."""
