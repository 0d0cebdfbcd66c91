"""Operation and byte counts of the work the inputs need, and the card's
published peaks: the yardstick of every roofline and mfu share."""
