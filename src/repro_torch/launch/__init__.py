"""Entry points of the port's LLM serving path (`serve`) and its step
functions (`steps`)."""
