"""Entry points of the port's LLM serving path (`serve`), its step
functions (`steps`) and the card's roofline constants (`mesh`)."""
