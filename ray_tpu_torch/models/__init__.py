"""Model zoo of the port: the Llama family (``llama``) and the Vision
Transformer (``vit``)."""
