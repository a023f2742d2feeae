"""Model definitions of the port (Qwen3 decoder, byte tokenizer)."""
