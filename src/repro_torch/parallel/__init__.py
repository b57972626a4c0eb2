"""Placement rules of the hybrid DP x TP x EP layout on a device mesh."""
