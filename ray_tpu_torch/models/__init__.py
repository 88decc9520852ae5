"""Model zoo of the port (Llama family)."""
