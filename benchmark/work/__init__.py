"""Operations and bytes of the work a cell does, counted from its shapes."""
