"""The plain PyTorch reference of the served models and of one
generation; imports nothing of the program under test."""
