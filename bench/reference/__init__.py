"""Plain references in PyTorch: brute-force exact kNN and the Jamba
period. They import nothing of the port and take nothing it made."""
