"""The Llama decoder, its weight converter and generation."""
